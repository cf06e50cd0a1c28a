"""
Times build variants of the Hopper attention kernels on the card.

``csrc/flash_attention.cu`` takes the number of warpgroups a block and of
ring stages of the bf16 forward, dQ and dK/dV kernels from six macros
(``ADELL_FWD_WARPGROUPS``, ``ADELL_FWD_STAGES``, ``ADELL_DQ_WARPGROUPS``,
``ADELL_DQ_STAGES``, ``ADELL_DKV_WARPGROUPS``, ``ADELL_DKV_STAGES``),
whose defaults are the shipped choice. This tool rebuilds the library once
per variant (one process each, the defines appended to
``build.NVCC_FLAGS``, which the build hashes), holds the three kernels
against their plain versions and times them at UNETR's shapes,
q, k, v ``[B, 8, 2048, 64]`` bf16, B = 1 and 2. The default is timed first
and last, so the table shows the run's spread.

    python -m adell_mri_torch.tools.tune_attention

needs one CUDA card and ``nvcc``; it writes
``chiprun_out/tune_attention.json`` and leaves the default build behind.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
VARIANTS = [
    {},
    {"ADELL_FWD_WARPGROUPS": 2, "ADELL_DQ_WARPGROUPS": 2,
     "ADELL_DKV_WARPGROUPS": 2},
    {"ADELL_FWD_STAGES": 2, "ADELL_DQ_STAGES": 4, "ADELL_DKV_STAGES": 2},
    {"ADELL_FWD_STAGES": 4, "ADELL_DQ_STAGES": 5, "ADELL_DKV_STAGES": 3},
    {"ADELL_FWD_WARPGROUPS": 2, "ADELL_FWD_STAGES": 4,
     "ADELL_DKV_WARPGROUPS": 2, "ADELL_DKV_STAGES": 3},
    {},
]


def measure(defines):
    """Builds with ``defines`` and returns the kernels' plans, errors and
    device times."""
    import ctypes

    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import time_ms

    from adell_mri_torch.ops.kernels import attention as ka
    from adell_mri_torch.ops.kernels import build

    build.NVCC_FLAGS += [f"-D{k}={v}" for k, v in defines.items()]
    lib = build.load_library()
    row = {"defines": defines, "plan": {}, "ms": {}, "max_abs_err": {}}
    for kind, stem in ((0, "fwd"), (1, "bwd_dq"), (2, "bwd_dkv")):
        plan = (ctypes.c_int * 3)()
        lib.adell_flash_plan_bf16(kind, 64, plan)
        row["plan"][stem] = dict(zip(("rows", "threads", "smem"), plan))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b in (1, 2):
        q, k, v, g = (
            torch.randn((b, 8, 2048, 64), generator=gen,
                        device="cuda").to(torch.bfloat16)
            for _ in range(4)
        )
        scale = 64 ** -0.5
        out, m, l = ka.flash_attention_fwd(q, k, v, scale)
        w_out, w_m, w_l = ka.flash_attention_fwd_reference(q, k, v, scale)
        lse, delta = ka.backward_rows(w_out, w_m, w_l, g)
        args = (q, k, v, g, lse, delta, scale)
        dq = ka.flash_attention_bwd_dq(*args)
        dk, dv = ka.flash_attention_bwd_dkv(*args)
        w_dq = ka.flash_attention_bwd_dq_reference(*args)
        w_dk, w_dv = ka.flash_attention_bwd_dkv_reference(*args)
        torch.cuda.synchronize()
        errs = {
            "out": (out.float() - w_out.float()).abs().max(),
            "dq": (dq.float() - w_dq.float()).abs().max(),
            "dk": (dk.float() - w_dk.float()).abs().max(),
            "dv": (dv.float() - w_dv.float()).abs().max(),
        }
        row["max_abs_err"][b] = {n: float(e) for n, e in errs.items()}
        row["ms"][b] = {
            "fwd": time_ms(lambda: ka.flash_attention_fwd(q, k, v, scale),
                           reps=20),
            "bwd_dq": time_ms(lambda: ka.flash_attention_bwd_dq(*args),
                              reps=20),
            "bwd_dkv": time_ms(lambda: ka.flash_attention_bwd_dkv(*args),
                               reps=20),
        }
    return row


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--one", help="JSON of one variant's defines: "
                        "measure it in this process and print the row")
    parser.add_argument("--variants", help="JSON list of defines to time "
                        "instead of the built-in list")
    args = parser.parse_args()
    variants = json.loads(args.variants) if args.variants else VARIANTS
    if args.one is not None:
        print(json.dumps(measure(json.loads(args.one))))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rows = []
    for defines in variants:
        done = subprocess.run(
            [sys.executable, "-m", "adell_mri_torch.tools.tune_attention",
             "--one", json.dumps(defines)],
            cwd=ROOT, check=True, capture_output=True, text=True,
            timeout=600,
        )
        row = json.loads(done.stdout.strip().splitlines()[-1])
        rows.append(row)
        ms, plan = row["ms"], row["plan"]
        print(
            f"{json.dumps(defines) if defines else 'default'}: fwd "
            f"{plan['fwd']} B=1 {ms['1']['fwd']:.4f} ms, B=2 "
            f"{ms['2']['fwd']:.4f} ms; dQ {plan['bwd_dq']} B=1 "
            f"{ms['1']['bwd_dq']:.4f} ms, B=2 {ms['2']['bwd_dq']:.4f} ms; "
            f"dK/dV {plan['bwd_dkv']} B=1 "
            f"{ms['1']['bwd_dkv']:.4f} ms, B=2 {ms['2']['bwd_dkv']:.4f} ms; "
            f"errors {row['max_abs_err']['2']}",
            flush=True,
        )
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "tune_attention.json").write_text(
        json.dumps({"nvidia_smi": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
