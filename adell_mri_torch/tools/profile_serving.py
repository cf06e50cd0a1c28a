"""
Where the time of one served case goes, on the GPU.

    python -m adell_mri_torch.tools.profile_serving \
        [unet|resnet|unetr|swin|catnet|catnet_convnext|vgg|convnext|vit|
         vit_crops|factorized_vit|ord|unet_classifier] \
        [--precision bf16|32]

Serves the model (bf16 by default, or f32 with ``--precision 32``, the
CLI's default; weights from seed 0) over a 256x256x64 case
through ``SegmentationInference`` as ``chip_smoke.py`` does: the flagship
U-Net, the resnet U-Net (``sample_configs/u-net-3d-resnet.yaml``) or
SWIN-UNet (``sample_configs/unet-swin.yaml``) with a 128x128x32
window at stride 0.5 in micro-batches of 4, or UNETR
(``sample_configs/unetr.yaml``) with the whole case as one window; or a
classifier (``tools/flagship.py``'s ``CLASSIFIERS``, eval mode, the
running statistics of two training forwards) on a micro-batch of 2
crops of 128x128x32, or for ``vit`` 2 volumes of 256x256x64 (4097
tokens: the flash kernels). After one warm-up case it times three cases with
the host clock, then runs one more under ``torch.profiler`` and prints
the device time by kernel group, the device-busy share of a case's wall time, and the top kernels.
The full table goes to ``chiprun_out/profile_serving_{model}.txt`` (or
``--out``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from adell_mri_torch.tools.flagship import (
    CLASSIFIERS,
    classifier_shape,
    make_case,
    make_catnet_batch,
    make_inference,
    make_model,
    make_served_classifier,
)
from adell_mri_torch.train.precision import compute_dtype

# kernel-name substrings -> group, first match wins (cuDNN's implicit-GEMM
# conv kernels carry "fprop" or "conv" and also "gemm", so they come first;
# in f32 the forward's preparation kernel, which writes the images of K and
# V, counts with the forward)
GROUPS = (
    ("flash_fwd", "flash_attention_fwd (K4/K5)"),
    ("flash_tf32x3_image", "flash_attention_fwd (K4/K5)"),
    ("conv3d_igemm", "conv3d_igemm (stride-1 3x3x3 convs)"),
    ("conv3d_wgmma", "conv3d_igemm (stride-1 3x3x3 convs)"),
    ("conv3d_narrow", "conv3d_igemm (stride-1 3x3x3 convs)"),
    ("CatArrayBatchedCopy", "concatenation"),
    ("reduce_kernel", "reductions (instance-norm statistics)"),
    ("depthwise", "depthwise convs (ConvNeXt blocks)"),
    ("fprop", "cuDNN convs (stride-2 downsampling)"),
    ("conv", "cuDNN convs (stride-2 downsampling)"),
    ("gemm", "matmuls (transposed convs, 1x1)"),
    ("nvjet", "matmuls (transposed convs, 1x1)"),
    ("layer_norm", "layer norms"),
    ("softmax", "softmax (materialised window attention)"),
    ("elementwise", "elementwise (norm apply, swish, casts, overlap-add)"),
)


def _self_device_us(evt):
    return float(evt.self_device_time_total)


def classifier_forward(name, dtype, batch=2):
    """``(forward, crops)``: the classifier ``name`` served
    (``make_served_classifier``), its parameters in ``dtype`` and its
    running statistics f32, and ``batch`` inputs of its size
    (``classifier_shape``: crops of 128x128x32, the ViT's whole
    256x256x64 volumes)."""
    model = make_served_classifier(0, name=name)
    for p in model.parameters():
        p.data = p.data.to(dtype)
    crops = make_catnet_batch(1, batch=4, shape=classifier_shape(name))[
        "image"][:batch]
    return (lambda x: model(x.to(dtype)).float()), crops


def main(name="unet", out_path=None, precision="bf16"):
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 1
    out_path = out_path or f"chiprun_out/profile_serving_{name}.txt"
    dtype = compute_dtype(precision) or torch.float32
    if name in CLASSIFIERS:
        infer, case = classifier_forward(name, dtype)
    else:
        infer = make_inference(make_model(0, dtype, name=name), name)
        case = make_case(1)
    with torch.inference_mode():
        infer(case)
        torch.cuda.synchronize()
        wall = []
        for _ in range(3):
            t0 = time.perf_counter()
            infer(case)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
        ) as prof:
            infer(case)
            torch.cuda.synchronize()
    # kernels only: a CPU-side op also reports the device time of the
    # kernels it launched, so summing both would count that time twice
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and _self_device_us(e) > 0
    ]
    total_us = sum(_self_device_us(e) for e in events)
    if total_us <= 0:
        print("profile_serving: the profiler saw no device time",
              file=sys.stderr)
        return 1
    groups = {}
    for e in events:
        label = next(
            (lab for key, lab in GROUPS if key in e.key), "other"
        )
        groups[label] = groups.get(label, 0.0) + _self_device_us(e)
    top = sorted(events, key=_self_device_us, reverse=True)[:12]
    device_s = total_us / 1e6
    summary = {
        "device": torch.cuda.get_device_name(0),
        "model": name,
        "precision": precision,
        "wall_s_per_case": wall,
        "device_busy_s_per_case": device_s,
        "device_busy_share": device_s / min(wall),
        "groups_ms": {k: v / 1e3 for k, v in sorted(
            groups.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": [
            [e.key[:80], _self_device_us(e) / 1e3, e.count] for e in top
        ],
    }
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))
    for k, v in summary["groups_ms"].items():
        print(f"  {v:9.3f} ms  {100 * v / (total_us / 1e3):5.1f} %  {k}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("model", nargs="?", default="unet",
                        choices=("unet", "resnet", "unetr", "swin",
                                 *CLASSIFIERS))
    parser.add_argument("--precision", default="bf16",
                        help="the CLI's --precision: bf16 or 32")
    parser.add_argument("--out", help="where the profiler's table goes")
    args = parser.parse_args()
    sys.exit(main(args.model, args.out, args.precision))
