"""
Times build variants of the Hopper conv kernels (K1 and its dW) on the card.

``csrc/conv3d_igemm.cu`` takes the wgmma kernel's warpgroups a block (64
output voxels each, so the box size), the weight ring's stages and the
products a ring stage holds from three macros (``ADELL_CONV_WARPGROUPS``,
``ADELL_CONV_STAGES``, ``ADELL_CONV_TAP_WORK``); ``csrc/conv3d_wgrad.cu``
takes the wgrad kernel's warpgroups a block, box buffers, accumulator
registers a thread (so T, the tiles a warpgroup) and the blocks an SM its
voxel split aims for (``ADELL_WGRAD_WARPGROUPS``, ``ADELL_WGRAD_STAGES``,
``ADELL_WGRAD_ACC``, ``ADELL_WGRAD_WAVES``). Their defaults are the
shipped choice. This tool rebuilds the library once per variant (one
process each, the defines appended to ``build.NVCC_FLAGS``, which the
build hashes), holds the forward, the dx launch and the dW of each
main-path conv shape class against the plain version, and times them:
the flagship
U-Net's 31 convs of one window batch (B=4 at 128x128x32), UNETR's 9
convs of one 256x256x64 case (B=1), and the stems of a three-sequence
U-Net (``STEM_CONVS``), bf16, with the narrow route's share of each
total. Ragged volumes with several small channel chunks and narrow ragged
shapes (``EDGE_CONVS``) are checked too, so that a variant that breaks
there is not timed as valid. dW (``conv3d_weight_grad``: the wgrad kernel
on its classes, the patch product on the others) is summed per model over
every conv and over the kernel's classes. Each class also gets the
host time to issue one forward launch (``host_us``: the wrapper's checks,
plan and allocation). The default is timed first and last, so the table
shows the run's spread.

    python -m adell_mri_torch.tools.tune_conv
    python -m adell_mri_torch.tools.tune_conv --compare build/parent

needs one CUDA card and ``nvcc``; it writes ``chiprun_out/tune_conv.json``
and leaves the default build behind. ``--compare DIR`` times the default
build of another checkout (for example the parent commit unpacked with
``git archive`` into the git-ignored ``build/``) against this one, in the
order other, this, this, other.
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


def measure(defines, root=ROOT):
    """Builds the checkout at ``root`` with ``defines`` and returns, for
    every shape class, the routes, the largest errors of the forward, the
    dx and dW against the plain version, their device ms (not for
    ``EDGE_CONVS``) and the host us of a forward launch, with per-model
    totals."""
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import time_ms

    sys.path.insert(0, str(root))
    from adell_mri_torch.ops.kernels import build
    from adell_mri_torch.ops.kernels import conv as kc

    build.NVCC_FLAGS += [f"-D{k}={v}" for k, v in defines.items()]
    lib = build.load_library()
    # a checkout from before the wgmma route has one kernel for all convs

    def route(cin, cout):
        if not hasattr(kc, "conv_route"):
            return "igemm"
        return kc.conv_route(torch.bfloat16, cin, cout)

    # a checkout from before the wgrad kernel has dW on the patch product
    # alone, which is then its own plain version
    def dw_route(cin, cout):
        if not hasattr(kc, "wgrad_route"):
            return "patches"
        return kc.wgrad_route(torch.bfloat16, cin, cout)

    dw_plain = getattr(kc, "conv3d_weight_grad_reference",
                       kc.conv3d_weight_grad)

    row = {"defines": defines, "root": str(root), "shapes": [],
           "totals": {}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for model, convs in MODELS.items():
        fwd = dx = fwd_narrow = dx_narrow = dw = dw_wgmma = 0.0
        for i, (b, spatial, cin, cout, count) in enumerate(convs):
            x = torch.randn((b, *spatial, cin), generator=gen,
                            device="cuda").to(torch.bfloat16)
            w = (torch.randn((3, 3, 3, cin, cout), generator=gen,
                             device="cuda") / (27 * cin) ** 0.5
                 ).to(torch.bfloat16)
            g = torch.randn((b, *spatial, cout), generator=gen,
                            device="cuda").to(torch.bfloat16)
            w_rot = w.flip(0, 1, 2).transpose(3, 4).contiguous()
            errs = []
            for got, want in ((kc.conv3d_igemm(x, w),
                               kc.conv3d_igemm_reference(x, w)),
                              (kc.conv3d_igemm_dx(g, w),
                               kc.conv3d_igemm_reference(g, w_rot))):
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                tol = 2.0**-7 * max(float(want.float().abs().max()), 1.0)
                errs.append((err, tol))
            got, want = kc.conv3d_weight_grad(x, g), dw_plain(x, g)
            torch.cuda.synchronize()
            # dW: one ulp of its own scale (both round an f32 sum once)
            errs.append((float((got.float() - want.float()).abs().max()),
                         2.0**-7 * float(want.float().abs().max())))
            timed = count > 0
            ms = time_ms(lambda: kc.conv3d_igemm(x, w)) if timed else None
            # the first conv of a model reads the image: no dx
            dx_ms = time_ms(lambda: kc.conv3d_igemm_dx(g, w)) if (
                timed and i > 0) else None
            dw_ms = time_ms(lambda: kc.conv3d_weight_grad(x, g)) if (
                timed) else None
            fwd += (ms or 0.0) * count
            dx += (dx_ms or 0.0) * count
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
                dw_route=dw_route(cin, cout), dw_max_abs_err=errs[2][0],
                dw_tol=errs[2][1], dw_ms=dw_ms,
                ok=all(e <= t for e, t in errs), ms=ms, dx_ms=dx_ms,
                host_us=host_us(lambda: kc.conv3d_igemm(x, w)),
            ))
        row["totals"][model] = {"fwd_ms": fwd, "dx_ms": dx,
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
    parser.add_argument("--root", default=str(ROOT), help="with --one: "
                        "the checkout whose kernels to build and time")
    parser.add_argument("--compare", help="another checkout: time its "
                        "default build against this one's, in turns")
    args = parser.parse_args()
    if args.one is not None:
        print(json.dumps(measure(json.loads(args.one), Path(args.root))))
        return 0
    if args.compare:
        other = str(Path(args.compare).resolve())
        runs = [({}, other), ({}, str(ROOT)), ({}, str(ROOT)), ({}, other)]
    else:
        variants = (WGRAD_VARIANTS if args.variants == "wgrad"
                    else json.loads(args.variants) if args.variants
                    else VARIANTS)
        runs = [(v, str(ROOT)) for v in variants]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    rows = []
    for defines, root in runs:
        # run as a file from the checkout's root, so that the package is
        # imported from that checkout and not from this one
        done = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--one", json.dumps(defines), "--root", root],
            cwd=root, check=True, capture_output=True, text=True,
            timeout=900,
        )
        row = json.loads(done.stdout.strip().splitlines()[-1])
        rows.append(row)
        bad = [r["shape"] for r in row["shapes"] if not r["ok"]]
        t = row["totals"]
        print(
            f"{root} {json.dumps(defines) if defines else 'default'}: "
            f"U-Net window "
            f"batch {t['unet']['fwd_ms']:.3f} ms, dx per step "
            f"{t['unet']['dx_ms']:.3f} ms; UNETR case "
            f"{t['unetr']['fwd_ms']:.3f} ms, dx per step "
            f"{t['unetr']['dx_ms']:.3f} ms; narrow route: U-Net "
            f"{t['unet']['fwd_narrow_ms']:.3f} + "
            f"{t['unet']['dx_narrow_ms']:.3f} ms, UNETR "
            f"{t['unetr']['fwd_narrow_ms']:.3f} ms, three-sequence stems "
            f"{t['stems']['fwd_ms']:.3f} + {t['stems']['dx_ms']:.3f} ms; "
            f"dW: U-Net step {t['unet']['dw_ms']:.3f} ms (wgrad kernel's "
            f"classes {t['unet']['dw_wgmma_ms']:.3f}), UNETR at B=1 "
            f"{t['unetr']['dw_ms']:.3f} ms ({t['unetr']['dw_wgmma_ms']:.3f}); "
            f"host {t['unet']['host_us']:.0f} "
            f"us to issue a window batch; beyond tolerance: {bad}",
            flush=True,
        )
        for r in row["shapes"]:
            print(f"  {r['model']} {r['shape']} x{r['count']} {r['route']}: "
                  f"{r['ms']} ms, dx {r['dx_ms']}, dW ({r['dw_route']}) "
                  f"{r['dw_ms']}, host {r['host_us']:.1f} us", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = "tune_conv_compare.json" if args.compare else "tune_conv.json"
    (out_dir / name).write_text(
        json.dumps({"nvidia_smi": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
