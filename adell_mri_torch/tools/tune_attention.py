"""
Times build variants of the Hopper attention kernels on the card.

``csrc/flash_attention.cu`` takes the number of warpgroups a block and of
ring stages of the bf16 forward, dQ and dK/dV kernels from six macros
(``ADELL_FWD_WARPGROUPS``, ``ADELL_FWD_STAGES``, ``ADELL_DQ_WARPGROUPS``,
``ADELL_DQ_STAGES``, ``ADELL_DKV_WARPGROUPS``, ``ADELL_DKV_STAGES``), whose
defaults are the shipped choice. This tool rebuilds the library once per
variant (one process each, the defines appended to ``build.NVCC_FLAGS``,
which the build hashes), holds the three kernels against their plain
versions before it times anything (bf16: one bf16 ulp of the output
scale; f32: 2e-5 forward, 1e-4 backward, as ``chip_smoke.py``, and the
forward's m within 1e-4 of its scale and l within 1e-4 relative; a variant
beyond them is recorded as failed, not timed), then times them at UNETR's
shapes, q, k, v ``[B, 8, 2048, 64]``, B = 1 and 2. The default is timed
first and last, so the table shows the run's spread. ``--dtype f32``
times the f32 kernels (the CLI's default precision), which have no build
knobs: without ``--variants`` or ``--compare`` the default build is timed
twice. ``--compare DIR`` times the default build of another checkout (for
example the parent commit unpacked with ``git archive`` into the
git-ignored ``build/``) against this one, in the order other, this, this,
other. The exit code is 1 when the default build fails, or either side of
``--compare``.

    python -m adell_mri_torch.tools.tune_attention [--dtype f32]
    python -m adell_mri_torch.tools.tune_attention --compare build/parent

needs one CUDA card and ``nvcc``; it writes
``chiprun_out/tune_attention.json`` (``tune_attention_compare.json`` with
``--compare``; ``_f32`` before the extension in f32) and leaves the default
build behind.
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
KINDS = ("fwd", "bwd_dq", "bwd_dkv")


def measure(defines, root=ROOT, dtype="bf16"):
    """Builds the checkout at ``root`` with ``defines``, holds its kernels
    against their plain versions and returns their plans, errors (each
    over its tolerance's scale) and device times."""
    import ctypes

    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import time_ms

    sys.path.insert(0, str(root))
    from adell_mri_torch.ops.kernels import attention as ka
    from adell_mri_torch.ops.kernels import build

    build.NVCC_FLAGS += [f"-D{k}={v}" for k, v in defines.items()]
    lib = build.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = dtype == "f32"
    tdtype = torch.float32 if f32 else torch.bfloat16
    row = {"defines": defines, "root": str(root), "dtype": dtype,
           "plan": {}, "ms": {}, "rel_err": {}}
    for kind, stem in enumerate(KINDS):
        # a checkout from before the f32 backward's images reports 3 values
        plan = (ctypes.c_int * 5)()
        getattr(lib, f"adell_flash_plan_{'f32' if f32 else 'bf16'}")(
            kind, 64, plan)
        row["plan"][stem] = list(plan)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b in (1, 2):
        q, k, v, g = (
            torch.randn((b, 8, 2048, 64), generator=gen,
                        device="cuda").to(tdtype)
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
        rel_f, rel_b = (2e-5, 1e-4) if f32 else (2.0**-7, 2.0**-7)
        errs = {}
        for name, got, want, rel in (("out", out, w_out, rel_f),
                                     ("dq", dq, w_dq, rel_b),
                                     ("dk", dk, w_dk, rel_b),
                                     ("dv", dv, w_dv, rel_b)):
            err = float((got.float() - want.float()).abs().max())
            errs[name] = err / (rel * float(want.float().abs().max()))
        if f32:
            # the forward's row statistics, as chip_smoke.py holds them
            errs["m"] = float((m - w_m).abs().max()) / (
                1e-4 * max(float(w_m.abs().max()), 1.0))
            errs["l"] = float(((l - w_l) / w_l).abs().max()) / 1e-4
        row["rel_err"][b] = errs
        if not all(e <= 1.0 for e in errs.values()):
            raise AssertionError(f"B={b}: kernels beyond tolerance "
                                 f"(error / tolerance): {errs}")
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
    parser.add_argument("--dtype", choices=("bf16", "f32"), default="bf16",
                        help="the kernels' type")
    parser.add_argument("--root", default=str(ROOT), help="with --one: "
                        "the checkout whose kernels to build and time")
    parser.add_argument("--compare", help="another checkout: time its "
                        "default build against this one's, in turns")
    args = parser.parse_args()
    dtype = args.dtype
    if args.one is not None:
        print(json.dumps(measure(json.loads(args.one), Path(args.root),
                                 dtype)))
        return 0
    if args.compare:
        other = str(Path(args.compare).resolve())
        runs = [({}, other), ({}, str(ROOT)), ({}, str(ROOT)), ({}, other)]
    else:
        # the built-in list varies the bf16 kernels; in f32, without a
        # list, the default build is timed twice
        variants = (json.loads(args.variants) if args.variants
                    else VARIANTS if dtype == "bf16" else [{}, {}])
        runs = [(v, str(ROOT)) for v in variants]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = "tune_attention_compare" if args.compare else "tune_attention"
    out_path = out_dir / (name + ("_f32.json" if dtype == "f32"
                                  else ".json"))
    rows, broken = [], False
    for defines, root in runs:
        # run as a file from the checkout's root, so that the package is
        # imported from that checkout and not from this one
        done = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--one", json.dumps(defines), "--root", root, "--dtype", dtype],
            cwd=root, capture_output=True, text=True, timeout=900,
        )
        label = f"{root} {json.dumps(defines) if defines else 'default'}"
        if done.returncode != 0:
            # a variant that does not build, run or agree is recorded, not
            # fatal; the default build's failure (either checkout's, with
            # --compare) is
            broken = broken or not defines
            rows.append({"defines": defines, "root": root,
                         "failed": done.stderr[-4000:]})
            print(f"{label} ({dtype}): failed: "
                  f"{done.stderr.strip().splitlines()[-1:]}", flush=True)
        else:
            row = json.loads(done.stdout.strip().splitlines()[-1])
            rows.append(row)
            ms, plan = row["ms"], row["plan"]
            print(
                f"{label} ({dtype}): "
                + "; ".join(
                    f"{stem} {plan[stem]} B=1 {ms['1'][stem]:.4f} ms, B=2 "
                    f"{ms['2'][stem]:.4f} ms" for stem in KINDS)
                + f"; error / tolerance at B=2 {row['rel_err']['2']}",
                flush=True,
            )
        out_path.write_text(
            json.dumps({"nvidia_smi": smi, "rows": rows}, indent=1))
    return 1 if broken else 0


if __name__ == "__main__":
    sys.exit(main())
