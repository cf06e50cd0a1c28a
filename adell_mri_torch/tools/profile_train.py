"""
Where the time of one training step goes, on the GPU.

    python -m adell_mri_torch.tools.profile_train \
        [unet|resnet|unetr|swin|catnet|catnet_convnext|vgg|convnext|vit|
         vit_crops|factorized_vit|ord|unet_classifier|ssl_<method>] \
        [--precision bf16|32] [--batch N]

Trains the model (f32 master weights from seed 0, bf16 compute or, with
``--precision 32``, f32 compute, the CLI's default; the CLI's
augmentation, Nesterov SGD) on a batch made on the card, as
``chip_smoke.py`` does: the flagship U-Net on 4 volumes of 128x128x32 with
the dice loss, UNETR (``sample_configs/unetr.yaml``, dropout 0) on 2
volumes of 256x256x64 or SWIN-UNet (``sample_configs/unet-swin.yaml``,
dropout 0) on 2 volumes of 128x128x32, both with their yaml's dice +
focal loss, or a classifier (``tools/flagship.py``'s ``CLASSIFIERS``:
CatNet with ``sample_configs/classification-cat-resnet.yaml`` or
``classification-cat-convnext.yaml``, VGG with ``vggnet-net.yaml``, each
on 16 crops of 128x128x32, the standalone ConvNeXt at the factory's
defaults on 4, the ViT classifier of ``classification-vit.yaml`` on 2
volumes of 256x256x64 with dropout 0, so that attention takes the flash
kernels, or on 4 crops of 128x128x32 with its dropout 0.1
(``vit_crops``), the factorized ViT at the factory's defaults on 4,
OrdNet on ``classification-cat-resnet.yaml``'s structure with 3 classes
on 16, the U-Net encoder classifier of ``u-net-3d-resnet.yaml`` on 2)
with binary labels (OrdNet's three) and the classifier's augmentation,
or a self-supervised ``--ssl_method`` (``ssl_vicreg``, ``ssl_dino``, ...:
``tools/flagship.py``'s ``make_ssl_trainer`` on ``ssl-resnet.yaml``'s 28
volumes of 128x128x32, with its views) (``--batch`` changes the volumes a
step). After one warm-up step it times three steps with the host clock, then runs one more under
``torch.profiler`` and prints the device time by kernel group, the
device-busy share of a step's wall time, the peak device memory and the
top kernels. Where the step augments with the intensity pass
(``transforms/pipeline.py:_batch_intensity``: parameter draws, the
min/max and std reductions, the seed, one K3 launch), the summary's
``intensity_pass`` gives that pass's kernel launches, their device us and
K3's share of them in the profiled step, and the host us it takes to
issue in the timed steps. The full table goes to
``chiprun_out/profile_train_{model}.txt`` (or ``--out``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from adell_mri_torch.config.factories import SSL_METHODS
from adell_mri_torch.tools.flagship import (
    CLASSIFIER_CLASSES,
    CLASSIFIERS,
    classifier_shape,
    make_catnet_batch,
    make_catnet_trainer,
    make_ssl_batch,
    make_ssl_trainer,
    make_train_batch,
    make_trainer,
    model_spec,
)

# kernel-name substrings -> group, first match wins (cuDNN's conv kernels
# also carry "gemm", so they come before the matmuls)
GROUPS = (
    ("flash_fwd", "flash_attention_fwd (K4/K5)"),
    ("flash_bwd_dq", "flash_attention_bwd_dq (K6)"),
    ("flash_bwd_dkv", "flash_attention_bwd_dkv (K7)"),
    ("flash_tf32x3_image", "f32 images of K4/K5, K6 and K7 (their "
     "preparation)"),
    ("conv3d_wgrad", "conv3d_wgrad (dW of K1's backward, with its "
     "reduction)"),
    ("conv3d_igemm", "conv3d_igemm (K1: stride-1 conv forward and dx)"),
    ("conv3d_wgmma", "conv3d_igemm (K1: stride-1 conv forward and dx)"),
    ("conv3d_narrow", "conv3d_igemm (K1: stride-1 conv forward and dx)"),
    ("intensity_aug", "intensity_aug (K3: fused intensity augmentation)"),
    ("fft", "FFT (Gibbs ringing)"),
    ("depthwise", "depthwise convs (ConvNeXt blocks; forward and "
     "backward)"),
    ("fprop", "cuDNN convs (stride-2, 5^3, 7^3; forward and backward)"),
    ("dgrad", "cuDNN convs (stride-2, 5^3, 7^3; forward and backward)"),
    ("wgrad", "cuDNN convs (stride-2, 5^3, 7^3; forward and backward)"),
    ("conv", "cuDNN convs (stride-2, 5^3, 7^3; forward and backward)"),
    ("gemm", "matmuls (the stems' dW patch products, transposed convs, "
     "1x1)"),
    ("nvjet", "matmuls (the stems' dW patch products, transposed convs, "
     "1x1)"),
    ("CatArrayBatchedCopy", "concatenation"),
    ("reduce_kernel", "reductions (norm statistics, sums)"),
    ("index", "gathers (warp)"),
    ("layer_norm", "layer norms"),
    ("softmax", "softmax (materialised window attention)"),
    ("elementwise", "elementwise (norms, swish, casts, the stems' patch "
     "copies)"),
)


def _self_device_us(evt):
    return float(evt.self_device_time_total)


INTENSITY_RANGE = "intensity pass"


class _IntensityPass:
    """Stands in for ``pipeline._batch_intensity`` while the tool runs:
    each call runs under the profiler range ``INTENSITY_RANGE`` and its
    host seconds are kept (nothing waits on the card in between)."""

    def __init__(self):
        from adell_mri_torch.transforms import pipeline

        self.pipeline, self.inner = pipeline, pipeline._batch_intensity
        self.host_s = []
        pipeline._batch_intensity = self

    def __call__(self, generator, image, policy):
        t0 = time.perf_counter()
        with record_function(INTENSITY_RANGE):
            out = self.inner(generator, image, policy)
        self.host_s.append(time.perf_counter() - t0)
        return out

    def restore(self):
        self.pipeline._batch_intensity = self.inner


def _subtree_kernels(evt):
    return [*evt.kernels,
            *(k for c in evt.cpu_children for k in _subtree_kernels(c))]


def intensity_pass_stats(prof, host_s):
    """The intensity pass of the profiled step: its calls, the kernels
    launched under its range (count, device us, the distinct names), K3's
    launches and device us (a ctypes launch has no torch op to hang from:
    found on the device timeline inside the range's span), the span from
    the range's first device activity to its last, and the host us a call
    took in the timed steps."""
    events = prof.events()
    ranges = [e for e in events if e.name == INTENSITY_RANGE]
    cpu = [r for r in ranges if r.device_type == DeviceType.CPU]
    spans = [r for r in ranges if r.device_type != DeviceType.CPU]
    kernels = [k for r in cpu for k in _subtree_kernels(r)]
    # without the range on the device timeline, the step's one pass holds
    # every K3 launch of the profile
    k3 = [e for e in events
          if e.device_type == DeviceType.CUDA and "intensity_aug" in e.name
          and (not spans or any(r.time_range.start <= e.time_range.start
                                <= r.time_range.end for r in spans))]
    k3_us = sum(e.time_range.elapsed_us() for e in k3)
    return {
        "calls": len(cpu),
        "launches": len(kernels) + len(k3),
        "device_us": sum(k.duration for k in kernels) + k3_us,
        "k3_launches": len(k3),
        "k3_device_us": k3_us,
        "span_us": sum(r.time_range.elapsed_us() for r in spans),
        "kernels": sorted({k.name[:60] for k in kernels}),
        "host_us": [t * 1e6 for t in host_s],
    }


def main(name="unet", out_path=None, precision="bf16", batch_size=None):
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    out_path = out_path or f"chiprun_out/profile_train_{name}.txt"
    if name.startswith("ssl_"):
        batch = make_ssl_batch(0, batch=batch_size)
        batch_size = batch["image"].shape[0]
        tr = make_ssl_trainer(0, precision, name[len("ssl_"):])
    elif name in CLASSIFIERS:
        batch_size = batch_size or CLASSIFIERS[name][2]
        batch = make_catnet_batch(
            0, batch=batch_size, shape=classifier_shape(name),
            n_classes=CLASSIFIER_CLASSES.get(name, 2))
        tr = make_catnet_trainer(
            0, precision, name=name,
            overrides={"dropout_rate": 0.0} if name == "vit" else None)
    else:
        spec = model_spec(name)
        batch_size = batch_size or spec.train_batch
        batch = make_train_batch(0, batch=batch_size, shape=spec.window)
        tr = make_trainer(0, precision, name=name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    intensity = _IntensityPass()

    def step():
        aug = (batch if tr.transforms is None
               else tr.transforms.augment(gen, batch))
        tr.state, _ = tr.train_step(tr.state, aug)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    host_s = intensity.host_s[-3:]
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    intensity.restore()
    # kernels only: a CPU-side op also reports the device time of the
    # kernels it launched, so summing both would count that time twice
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and _self_device_us(e) > 0
    ]
    total_us = sum(_self_device_us(e) for e in events)
    if total_us <= 0:
        print("profile_train: the profiler saw no device time",
              file=sys.stderr)
        return 1
    groups = {}
    for e in events:
        label = next(
            (lab for key, lab in GROUPS if key in e.key), "other"
        )
        groups[label] = groups.get(label, 0.0) + _self_device_us(e)
    top = sorted(events, key=_self_device_us, reverse=True)[:15]
    device_s = total_us / 1e6
    summary = {
        "device": torch.cuda.get_device_name(0),
        "model": name,
        "precision": precision,
        "batch": batch_size,
        "wall_s_per_step": wall,
        "profiled_step_wall_s": profiled_wall,
        "device_busy_s_per_step": device_s,
        "device_busy_share": device_s / min(wall),
        "peak_memory_gb": peak_gb,
        "groups_ms": {k: v / 1e3 for k, v in sorted(
            groups.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": [
            [e.key[:80], _self_device_us(e) / 1e3, e.count] for e in top
        ],
    }
    if host_s:
        summary["intensity_pass"] = intensity_pass_stats(prof, host_s)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=50))
    for k, v in summary["groups_ms"].items():
        print(f"  {v:9.3f} ms  {100 * v / (total_us / 1e3):5.1f} %  {k}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("model", nargs="?", default="unet",
                        choices=("unet", "resnet", "unetr", "swin",
                                 *CLASSIFIERS,
                                 *(f"ssl_{m}" for m in SSL_METHODS)))
    parser.add_argument("--precision", default="bf16",
                        help="the CLI's --precision: bf16 or 32")
    parser.add_argument("--out", help="where the profiler's table goes")
    parser.add_argument("--batch", type=int, help="volumes a step (default: "
                        "the model's training batch, 4, 2, 16 or 28)")
    args = parser.parse_args()
    sys.exit(main(args.model, args.out, args.precision, args.batch))
