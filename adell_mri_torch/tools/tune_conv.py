"""
Times build variants of the Hopper conv kernels (K1 and its dW) on the card.

``csrc/conv3d_igemm.cu`` takes the bf16 wgmma kernel's warpgroups a block
(64 output voxels each, so the box size), the weight ring's stages and the
products a ring stage holds from three macros (``ADELL_CONV_WARPGROUPS``,
``ADELL_CONV_STAGES``, ``ADELL_CONV_TAP_WORK``); ``csrc/conv3d_wgrad.cu``
takes the wgrad kernel's warpgroups a block, box buffers, accumulator
registers a thread (so T, the tiles a warpgroup) and the blocks an SM its
voxel split aims for (``ADELL_WGRAD_WARPGROUPS``, ``ADELL_WGRAD_STAGES``,
``ADELL_WGRAD_ACC``, ``ADELL_WGRAD_WAVES``). Their defaults are the
shipped choice. This tool rebuilds the library once per variant (one
process each, the defines appended to ``build.NVCC_FLAGS``, which the
build hashes), holds the forward, the dx launch and (bf16) the dW of each
main-path conv shape class against the plain version, and times them
beside ``F.conv3d`` (cuDNN; in f32 with TF32 off): the flagship U-Net's 31
convs of one window batch (B=4 at 128x128x32), UNETR's 9 convs of one
256x256x64 case (B=1), and the stems of a three-sequence U-Net
(``STEM_CONVS``), with the narrow route's share of each total. ``--dtype
f32`` (the CLI's default precision) times the same classes in f32, where
the forward and dx take the 3xTF32 kernel and dW the patch product, which
is not timed; the 3xTF32 kernel has no build knobs, so without
``--variants`` or ``--compare`` the default build is timed twice. Ragged
volumes with several small channel chunks and narrow ragged shapes
(``EDGE_CONVS``) are checked too, so that a variant that breaks there is
not timed as valid. dW (``conv3d_weight_grad``: the wgrad
kernel on its classes, the patch product on the others) is summed per
model over every conv and over the kernel's classes. Each class also gets
the host time to issue one forward launch (``host_us``: the wrapper's
checks, plan and allocation). The default is timed first and last, so the
table shows the run's spread. A variant that does not build or run is
recorded and the others go on; the exit code is 1 when the default build
fails, or either side of ``--compare``.

    python -m adell_mri_torch.tools.tune_conv [--dtype f32]
    python -m adell_mri_torch.tools.tune_conv --variants wgrad
    python -m adell_mri_torch.tools.tune_conv --compare build/parent

needs one CUDA card and ``nvcc``; it writes ``chiprun_out/tune_conv.json``
(``tune_conv_compare.json`` with ``--compare``; ``_f32`` before the
extension in f32) and leaves the default build behind. ``--compare DIR``
times the default build of another checkout (for example the parent
commit unpacked with ``git archive`` into the git-ignored ``build/``)
against this one, in the order other, this, this, other.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
VARIANTS = [
    {},
    {"ADELL_CONV_WARPGROUPS": 1},
    {"ADELL_CONV_STAGES": 3},
    {"ADELL_CONV_STAGES": 6},
    {"ADELL_CONV_TAP_WORK": 4096},
    {"ADELL_CONV_TAP_WORK": 8192},
    # all 27 taps of a 16-channel chunk in one stage: a chunk is one step
    {"ADELL_CONV_STAGES": 3, "ADELL_CONV_TAP_WORK": 8192},
    {},
]
# the wgrad kernel's variants (--variants wgrad)
WGRAD_VARIANTS = [
    {},
    {"ADELL_WGRAD_STAGES": 1},
    {"ADELL_WGRAD_STAGES": 3},
    {"ADELL_WGRAD_WARPGROUPS": 1},
    {"ADELL_WGRAD_ACC": 64},
    {"ADELL_WGRAD_WAVES": 1},
    {"ADELL_WGRAD_WAVES": 4},
    {},
]

# (batch, spatial, Cin, Cout, count) of the stride-1 3x3x3 convs of one
# forward; every conv but the one that reads the image has a dx launch
UNET_CONVS = [
    (4, (128, 128, 32), 1, 1, 1), (4, (128, 128, 32), 1, 32, 1),
    (4, (128, 128, 32), 32, 32, 3), (4, (128, 128, 32), 64, 64, 1),
    (4, (128, 128, 32), 64, 32, 1),
    (4, (64, 64, 16), 32, 32, 5), (4, (64, 64, 16), 64, 64, 1),
    (4, (64, 64, 16), 64, 32, 1),
    (4, (32, 32, 8), 32, 32, 2), (4, (32, 32, 8), 32, 64, 1),
    (4, (32, 32, 8), 64, 64, 2), (4, (32, 32, 8), 128, 128, 1),
    (4, (32, 32, 8), 128, 64, 1),
    (4, (16, 16, 4), 64, 64, 2), (4, (16, 16, 4), 64, 128, 1),
    (4, (16, 16, 4), 128, 128, 2), (4, (16, 16, 4), 256, 256, 1),
    (4, (16, 16, 4), 256, 128, 1),
    (4, (8, 8, 2), 128, 128, 2), (4, (8, 8, 2), 128, 256, 1),
]
UNETR_CONVS = [
    (1, (256, 256, 64), 1, 16, 1), (1, (256, 256, 64), 32, 16, 1),
    (1, (256, 256, 64), 16, 16, 1),
    (1, (128, 128, 32), 64, 32, 1), (1, (128, 128, 32), 32, 32, 1),
    (1, (64, 64, 16), 128, 64, 1), (1, (64, 64, 16), 64, 64, 1),
    (1, (32, 32, 8), 256, 128, 1), (1, (32, 32, 8), 128, 128, 1),
]
# the stems of a U-Net on three sequences (segmentation train --image_keys
# T2W HBV ADC): 3->3 reads the images, 3->32 has a 32->3 dx
STEM_CONVS = [
    (4, (128, 128, 32), 3, 3, 1), (4, (128, 128, 32), 3, 32, 1),
]
# ragged volumes whose channels come in several chunks of 16 or 32: they
# reach the ring's chunk changes at the fewest steps a chunk; and ragged
# narrow convs (not timed)
EDGE_CONVS = [
    (1, (7, 9, 5), 48, 24, 0), (1, (7, 9, 5), 48, 32, 0),
    (2, (12, 10, 9), 96, 32, 0), (1, (7, 9, 5), 16, 16, 0),
    (1, (7, 9, 5), 1, 16, 0), (1, (7, 9, 5), 3, 8, 0),
    (1, (7, 9, 5), 24, 1, 0),
]
# f32: the 3xTF32 kernel's chunks of 8 and 16 channels, several of them,
# and an N block padded (8 -> 16, 24 -> 32)
F32_EDGE_CONVS = [
    (1, (7, 9, 5), 8, 8, 0), (1, (7, 9, 5), 24, 24, 0),
    (2, (3, 5, 7), 8, 24, 0),
]
MODELS = {"unet": UNET_CONVS, "unetr": UNETR_CONVS, "stems": STEM_CONVS,
          "edges": EDGE_CONVS}


def host_us(fn, reps=50):
    """Host microseconds to issue one call of ``fn`` (nothing waits on the
    card in between)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def measure(defines, root=ROOT, dtype="bf16"):
    """Builds the checkout at ``root`` with ``defines`` and returns, for
    every shape class in ``dtype`` (bf16 or f32), the routes, the largest
    errors of the forward, the dx and (bf16) dW against the plain version,
    their device ms and ``F.conv3d``'s (not for the edge shapes) and the
    host us of a forward launch, with per-model totals."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(ROOT))
    from chip_smoke import time_ms

    sys.path.insert(0, str(root))
    from adell_mri_torch.ops.kernels import build
    from adell_mri_torch.ops.kernels import conv as kc

    build.NVCC_FLAGS += [f"-D{k}={v}" for k, v in defines.items()]
    build.load_library()
    f32 = dtype == "f32"
    tdtype = torch.float32 if f32 else torch.bfloat16
    # the plain version and the library in full f32
    torch.backends.cudnn.allow_tf32 = False
    # a checkout from before the wgmma route has one kernel for all convs

    def route(cin, cout):
        if not hasattr(kc, "conv_route"):
            return "igemm"
        return kc.conv_route(tdtype, cin, cout)

    # a checkout from before the wgrad kernel has dW on the patch product
    # alone, which is then its own plain version
    def dw_route(cin, cout):
        if not hasattr(kc, "wgrad_route"):
            return "patches"
        return kc.wgrad_route(torch.bfloat16, cin, cout)

    dw_plain = getattr(kc, "conv3d_weight_grad_reference",
                       kc.conv3d_weight_grad)

    row = {"defines": defines, "root": str(root), "dtype": dtype,
           "shapes": [], "totals": {}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    models = dict(MODELS)
    if f32:
        models["edges"] = EDGE_CONVS + F32_EDGE_CONVS
    for model, convs in models.items():
        fwd = dx = fwd_narrow = dx_narrow = dw = dw_wgmma = 0.0
        fwd_lib = dx_lib = 0.0
        for i, (b, spatial, cin, cout, count) in enumerate(convs):
            x = torch.randn((b, *spatial, cin), generator=gen,
                            device="cuda").to(tdtype)
            w = (torch.randn((3, 3, 3, cin, cout), generator=gen,
                             device="cuda") / (27 * cin) ** 0.5
                 ).to(tdtype)
            g = torch.randn((b, *spatial, cout), generator=gen,
                            device="cuda").to(tdtype)
            w_rot = w.flip(0, 1, 2).transpose(3, 4).contiguous()
            errs = []
            for got, want in ((kc.conv3d_igemm(x, w),
                               kc.conv3d_igemm_reference(x, w)),
                              (kc.conv3d_igemm_dx(g, w),
                               kc.conv3d_igemm_reference(g, w_rot))):
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                # bf16: one ulp; f32: 1e-5 of the scale, which one tf32
                # pass (about 3e-4) does not meet
                tol = 1e-5 * scale if f32 else 2.0**-7 * max(scale, 1.0)
                errs.append((err, tol))
            if not f32:
                got, want = kc.conv3d_weight_grad(x, g), dw_plain(x, g)
                torch.cuda.synchronize()
                # dW: one ulp of its own scale (both round an f32 sum once)
                errs.append((
                    float((got.float() - want.float()).abs().max()),
                    2.0**-7 * float(want.float().abs().max())))
            timed = count > 0
            ms = time_ms(lambda: kc.conv3d_igemm(x, w)) if timed else None
            xc, wc = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2)
            gc, wrc = g.permute(0, 4, 1, 2, 3), w_rot.permute(4, 3, 0, 1, 2)
            lib_ms = time_ms(lambda: F.conv3d(xc, wc, padding=1)) if (
                timed) else None
            # the first conv of a model reads the image: no dx
            dx_ms = time_ms(lambda: kc.conv3d_igemm_dx(g, w)) if (
                timed and i > 0) else None
            dx_lib_ms = time_ms(lambda: F.conv3d(gc, wrc, padding=1)) if (
                timed and i > 0) else None
            dw_ms = time_ms(lambda: kc.conv3d_weight_grad(x, g)) if (
                timed and not f32) else None
            fwd += (ms or 0.0) * count
            dx += (dx_ms or 0.0) * count
            fwd_lib += (lib_ms or 0.0) * count
            dx_lib += (dx_lib_ms or 0.0) * count
            dw += (dw_ms or 0.0) * count
            if dw_route(cin, cout) == "wgmma":
                dw_wgmma += (dw_ms or 0.0) * count
            if route(cin, cout) == "narrow":
                fwd_narrow += (ms or 0.0) * count
            if route(cout, cin) == "narrow":
                dx_narrow += (dx_ms or 0.0) * count
            row["shapes"].append(dict(
                model=model, shape=[b, *spatial, cin, cout], count=count,
                route=route(cin, cout), dx_route=route(cout, cin),
                max_abs_err=errs[0][0], tol=errs[0][1],
                dx_max_abs_err=errs[1][0], dx_tol=errs[1][1],
                dw_route=None if f32 else dw_route(cin, cout),
                dw_max_abs_err=None if f32 else errs[2][0],
                dw_tol=None if f32 else errs[2][1], dw_ms=dw_ms,
                ok=all(e <= t for e, t in errs), ms=ms, dx_ms=dx_ms,
                library_ms=lib_ms, dx_library_ms=dx_lib_ms,
                host_us=host_us(lambda: kc.conv3d_igemm(x, w)),
            ))
            del x, w, g, w_rot
        torch.cuda.empty_cache()
        row["totals"][model] = {"fwd_ms": fwd, "dx_ms": dx,
                                "fwd_library_ms": fwd_lib,
                                "dx_library_ms": dx_lib,
                                "fwd_narrow_ms": fwd_narrow,
                                "dx_narrow_ms": dx_narrow, "dw_ms": dw,
                                "dw_wgmma_ms": dw_wgmma}
    # host time to issue the forward launches of one window batch
    row["totals"]["unet"]["host_us"] = sum(
        r["host_us"] * r["count"] for r in row["shapes"]
        if r["model"] == "unet")
    return row


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("--one", help="JSON of one variant's defines: "
                        "measure it in this process and print the row")
    parser.add_argument("--variants", help="JSON list of defines to time "
                        "instead of the built-in list, or 'wgrad' for the "
                        "wgrad kernel's list")
    parser.add_argument("--dtype", choices=("bf16", "f32"), default="bf16",
                        help="the convs' type")
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
        variants = (WGRAD_VARIANTS if args.variants == "wgrad"
                    else json.loads(args.variants) if args.variants
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
    name = "tune_conv_compare" if args.compare else "tune_conv"
    out_path = out_dir / (name + ("_f32.json" if dtype == "f32" else ".json"))
    rows, broken = [], False
    for n, (defines, root) in enumerate(runs):
        # run as a file from the checkout's root, so that the package is
        # imported from that checkout and not from this one
        done = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--one", json.dumps(defines), "--root", root, "--dtype", dtype],
            cwd=root, capture_output=True, text=True, timeout=900,
        )
        label = f"{root} {json.dumps(defines) if defines else 'default'}"
        if done.returncode != 0:
            # a variant that does not build or run is recorded, not fatal;
            # the default build's failure (either checkout's, with
            # --compare) is
            broken = broken or not defines
            rows.append({"defines": defines, "root": root,
                         "failed": done.stderr[-4000:]})
            print(f"{label} ({dtype}): failed: "
                  f"{done.stderr.strip().splitlines()[-1:]}", flush=True)
        else:
            row = json.loads(done.stdout.strip().splitlines()[-1])
            rows.append(row)
            print(f"{label} ({dtype}): {summary(row, dtype)}", flush=True)
            # every class of the first run; the JSON has every run's
            for r in row["shapes"] if n == 0 else ():
                print(f"  {r['model']} {r['shape']} x{r['count']} "
                      f"{r['route']}: {r['ms']} ms (F.conv3d "
                      f"{r['library_ms']}), dx {r['dx_ms']} "
                      f"({r['dx_library_ms']}), dW ({r['dw_route']}) "
                      f"{r['dw_ms']}, host {r['host_us']:.1f} us; err "
                      f"{r['max_abs_err']:.3g} / {r['tol']:.3g}, dx "
                      f"{r['dx_max_abs_err']:.3g} / {r['dx_tol']:.3g}",
                      flush=True)
        out_path.write_text(
            json.dumps({"nvidia_smi": smi, "rows": rows}, indent=1))
    return 1 if broken else 0


def summary(row, dtype):
    """One line of a run's totals, the shapes beyond tolerance and the
    largest error against its tolerance."""
    t = row["totals"]
    worst = max(max(r["max_abs_err"] / r["tol"], r["dx_max_abs_err"]
                    / r["dx_tol"]) for r in row["shapes"])
    bad = [r["shape"] for r in row["shapes"] if not r["ok"]]
    line = (
        f"U-Net window batch {t['unet']['fwd_ms']:.3f} ms (F.conv3d "
        f"{t['unet']['fwd_library_ms']:.3f}), dx per step "
        f"{t['unet']['dx_ms']:.3f} ms ({t['unet']['dx_library_ms']:.3f}); "
        f"UNETR case {t['unetr']['fwd_ms']:.3f} ms "
        f"({t['unetr']['fwd_library_ms']:.3f}), dx per step "
        f"{t['unetr']['dx_ms']:.3f} ms ({t['unetr']['dx_library_ms']:.3f}); "
        f"narrow route: U-Net {t['unet']['fwd_narrow_ms']:.3f} + "
        f"{t['unet']['dx_narrow_ms']:.3f} ms, UNETR "
        f"{t['unetr']['fwd_narrow_ms']:.3f} ms, three-sequence stems "
        f"{t['stems']['fwd_ms']:.3f} + {t['stems']['dx_ms']:.3f} ms; ")
    if dtype == "bf16":
        line += (
            f"dW: U-Net step {t['unet']['dw_ms']:.3f} ms (wgrad kernel's "
            f"classes {t['unet']['dw_wgmma_ms']:.3f}), UNETR at B=1 "
            f"{t['unetr']['dw_ms']:.3f} ms ({t['unetr']['dw_wgmma_ms']:.3f});"
            " ")
    return line + (f"host {t['unet']['host_us']:.0f} us to issue a window "
                   f"batch; largest error / tolerance {worst:.3f}; beyond "
                   f"tolerance: {bad}")


if __name__ == "__main__":
    sys.exit(main())
