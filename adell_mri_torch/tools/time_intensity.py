"""
Times the intensity kernel (K2/K3) in every mode on the card, beside
another checkout's.

    python -m adell_mri_torch.tools.time_intensity [--compare DIR] [--cpu]

For f32 and bf16 at the flagship batch [4,128,128,32,1] (the data and
parameters of ``chip_smoke.py``'s phase 6) with noise off, Gaussian and
Rician (every sample noisy, sigma 0.02), and K2's B=1 call (Rician), it
times this checkout's kernel with L2 warm (``timing.time_ms``: repeated
calls on the same tensors) and cold (``timing.time_cold_ms``), beside
``Tensor.copy_`` of the same input (the bytes alone, timed the same
ways). ``--compare DIR`` compiles ``DIR/adell_mri_torch/csrc/
intensity_aug.cu`` alone (with this checkout's ``NVCC_FLAGS``) into
``build/intensity_compare/`` and times it on the same calls, in turns
(other, this, this, other). Each build's noise-free output is held to the
plain version (1e-5 in f32, one bf16 ulp of the output's scale in bf16),
and this build's output is compared with the other's on every call (0:
the same bits). Phase 6 of ``chip_smoke.py`` holds the noisy output.
Prints the rows with the card's name and power limit and writes
``chiprun_out/time_intensity.json``. Needs one card, and ``nvcc`` for
``--compare``; exits 1 when a check fails.

``--cpu`` times the plain version, ``intensity_aug_reference``, instead,
on the CPU at the same batch in every mode (the fastest of 3 calls, f32;
with ``--compare``, the other checkout's beside it), as the CPU paths
and the tests pay it.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SIGMA = 0.02
# (mode, batch, noise, rician): the flagship batch in each mode, and K2
MODES = (("off", 4, False, False), ("gaussian", 4, True, False),
         ("rician", 4, True, True), ("k2_rician", 1, True, True))


def build_alone(root):
    """Compiles ``root``'s intensity kernel alone into a shared library
    under ``build/intensity_compare/`` and binds its two C entries (the
    interface of this checkout's)."""
    from adell_mri_torch.ops.kernels import build

    src = Path(root).resolve() / "adell_mri_torch" / "csrc" / \
        "intensity_aug.cu"
    out_dir = build.BUILD_DIR.parent / "intensity_compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libintensity_other.so"
    done = subprocess.run(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", str(src), "-o",
         str(lib_path)], capture_output=True, text=True, timeout=600)
    (out_dir / "build_other.log").write_text(done.stdout + done.stderr)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{done.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for suffix in ("_bf16", "_f32"):
        fn = getattr(lib, "adell_intensity_aug" + suffix)
        fn.argtypes = build._SIGNATURES["adell_intensity_aug"]
        fn.restype = ctypes.c_int
    return lib


def raw_call(lib, x, par, seed, noise, rician):
    """One launch through the library's C entry (no wrapper, no launch
    count), into a fixed output."""
    import torch

    from adell_mri_torch.ops.kernels import intensity as ki

    fn = getattr(lib, ki._LAUNCHERS[x.dtype])
    out = torch.empty_like(x)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count

    def call():
        rc = fn(x.data_ptr(), out.data_ptr(), par.data_ptr(),
                seed.data_ptr(), x.shape[0], x[0].numel(), int(noise),
                int(rician), n_sm, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"intensity launch failed: cudaError {rc}")
        return out

    return call


def inputs(dtype, batch):
    """Phase 6's data and parameters: x uniform in [0, 1), gammas 0.7 to
    1.5, scales and shifts around 1 and 0; every sigma 0, and every
    sigma ``SIGMA``."""
    import torch

    from adell_mri_torch.tools.flagship import BATCH, WINDOW

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    x32 = torch.rand((BATCH,) + WINDOW + (1,), generator=g,
                     device=dev)[:batch].contiguous()
    red = tuple(range(1, x32.dim()))
    fixed = torch.tensor([[0.7, 1.0, 0.0], [1.0, 1.05, 0.05],
                          [1.3, 0.95, -0.05], [1.5, 1.0, 0.02]],
                         device=dev)[:batch]

    def par_for(sigma):
        return torch.stack([x32.amin(dim=red), x32.amax(dim=red),
                            fixed[:, 0], fixed[:, 1], fixed[:, 2],
                            torch.full((batch,), sigma, device=dev)],
                           dim=1).contiguous()

    seed = torch.tensor([1234], dtype=torch.int64, device=dev)
    return x32.to(dtype), par_for(0.0), par_for(SIGMA), seed


def time_plain_cpu(other_root=None):
    """Host ms of the plain version at the flagship batch in every mode,
    this checkout's and ``other_root``'s (its ``ops/kernels/intensity.py``
    loaded by path)."""
    import importlib.util
    import time

    import torch

    from adell_mri_torch.ops.kernels import intensity as ki
    from adell_mri_torch.tools.flagship import BATCH, WINDOW

    mods = {"this": ki}
    if other_root:
        path = Path(other_root).resolve() / "adell_mri_torch" / "ops" / \
            "kernels" / "intensity.py"
        spec = importlib.util.spec_from_file_location("other_intensity",
                                                      path)
        mods["other"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods["other"])
    g = torch.Generator().manual_seed(6)
    x = torch.rand((BATCH,) + WINDOW + (1,), generator=g)
    red = tuple(range(1, x.dim()))
    par = torch.stack([x.amin(dim=red), x.amax(dim=red),
                       torch.tensor([0.7, 1.0, 1.3, 1.5]),
                       torch.ones(BATCH), torch.zeros(BATCH),
                       torch.full((BATCH,), SIGMA)], dim=1)
    seed = torch.tensor([1234], dtype=torch.int64)
    rows = []
    for mode, _, noise, rician in MODES[:3]:
        row = dict(mode=mode, shape=list(x.shape),
                   threads=torch.get_num_threads())
        for k, mod in mods.items():
            ts = []
            for _ in range(4):
                t = time.perf_counter()
                mod.intensity_aug_reference(seed, x, par, rician, noise)
                ts.append(time.perf_counter() - t)
            row[k] = dict(host_ms=min(ts[1:]) * 1e3)
        rows.append(row)
        print(f"plain {mode} {list(x.shape)} on {row['threads']} CPU "
              f"threads: " + "; ".join(f"{k} {row[k]['host_ms']:.1f} ms"
                                       for k in mods), flush=True)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--compare", help="another checkout: time its "
                        "intensity kernel against this one's, in turns")
    parser.add_argument("--cpu", action="store_true", help="time the plain "
                        "version on the CPU instead")
    args = parser.parse_args(argv)

    import torch

    if args.cpu:
        time_plain_cpu(args.compare)
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("time_intensity: no CUDA device")

    from adell_mri_torch.ops.kernels import intensity as ki
    from adell_mri_torch.ops.kernels.build import load_library
    from adell_mri_torch.tools.timing import time_cold_ms, time_ms

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = {}
    if args.compare:
        libs["other"] = build_alone(args.compare)
    libs["this"] = load_library()
    rows, failed = [], False
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for mode, batch, noise, rician in MODES:
            x, par0, par, seed = inputs(dtype, batch)
            p = par if noise else par0
            calls = {k: raw_call(lib, x, p, seed, noise, rician)
                     for k, lib in libs.items()}
            want = ki.intensity_aug_reference(seed, x, par0, False, False)
            tol = 1e-5 if dtype == torch.float32 else 2.0**-7 * max(
                float(want.float().abs().max()), 1.0)
            checks = {}
            for k, lib in libs.items():
                got = raw_call(lib, x, par0, seed, False, False)()
                err = float((got.float() - want.float()).abs().max())
                checks[k] = dict(clean_max_abs_err=err, tol=tol)
                failed |= not err <= tol
            if "other" in calls:
                other = calls["other"]().clone()
                checks["this"]["max_abs_diff_other"] = float(
                    (calls["this"]().float() - other.float()).abs().max())
            order = list(calls) + list(calls)[::-1]
            times = {k: dict(warm_ms=[], cold_ms=[]) for k in calls}
            for k in order:
                times[k]["warm_ms"].append(time_ms(calls[k], 20))
                times[k]["cold_ms"].append(time_cold_ms(calls[k], 20))
            # a yardstick of the same bytes: one copy of x into a buffer
            dst = torch.empty_like(x)

            def copy():
                dst.copy_(x)

            row = dict(dtype=name, mode=mode, shape=list(x.shape),
                       copy=dict(warm_ms=time_ms(copy, 20),
                                 cold_ms=time_cold_ms(copy, 20)),
                       **{k: dict(times[k], **checks[k]) for k in calls})
            rows.append(row)
            print(f"{name} {mode} {list(x.shape)}: copy_ warm "
                  f"{row['copy']['warm_ms']:.5f} cold "
                  f"{row['copy']['cold_ms']:.5f} ms; " + "; ".join(
                      f"{k} warm {', '.join(f'{t:.5f}' for t in v['warm_ms'])}"
                      f" cold {', '.join(f'{t:.5f}' for t in v['cold_ms'])}"
                      f" ms, clean err {checks[k]['clean_max_abs_err']:.3g}"
                      + (f", vs other {checks[k]['max_abs_diff_other']:.3g}"
                         if "max_abs_diff_other" in checks[k] else "")
                      for k, v in times.items()), flush=True)
    out = dict(nvidia_smi=smi, compare=args.compare, rows=rows)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "time_intensity.json").write_text(json.dumps(out, indent=1))
    if failed:
        print("time_intensity: a clean output is off its plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
