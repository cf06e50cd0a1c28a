"""
How far f32 rounding moves a classifier's training gradient, on the GPU.

    python -m adell_mri_torch.tools.gradient_conditioning [catnet_gp|...]

One f32 training step's gradient of ``tools/flagship.py``'s classifier
(f32 master weights from seed 0, its batch of crops from
``make_catnet_batch(2)``, dropout seeded alike in every run), taken five
ways: on the kernels twice, on the plain path (the stride-1 convs through
``F.conv3d``), on the plain path with the input moved by 1e-6 of its
spread, and on the plain path in f64. Each f32 gradient's distance from
another, ``||a - b|| / ||b||``, is summed over the leaves whose f64
gradient is above rounding level (largest element at least 1e-5 of the
largest of all: the biases ahead of batch norms fall below it). TF32 is
off, as in ``classification train``. Prints the card's name and power
limit, then one JSON line.
"""

import argparse
import json
import subprocess
import sys

PERTURBATION = 1e-6
ROUNDING_GRADIENT = 1e-5


class plain_convs:
    """Within the block the models' stride-1 convs take the plain version
    (autograd through ``F.conv3d``) instead of the kernel."""

    def __enter__(self):
        import adell_mri_torch.ops.conv as conv_mod
        from adell_mri_torch.ops.kernels.conv import conv3d_igemm_reference

        self.real = conv_mod.conv3d_igemm_train
        conv_mod.conv3d_igemm_train = conv3d_igemm_reference

    def __exit__(self, *exc):
        import adell_mri_torch.ops.conv as conv_mod

        conv_mod.conv3d_igemm_train = self.real
        return False


def main(argv=None):
    import contextlib

    import torch

    from adell_mri_torch.models.layers.dropout import seed_dropout
    from adell_mri_torch.ops.kernels import build
    from adell_mri_torch.tools.flagship import (
        CLASSIFIER_CLASSES,
        CLASSIFIERS,
        classifier_shape,
        make_catnet_batch,
        make_catnet_trainer,
    )

    parser = argparse.ArgumentParser(prog="gradient_conditioning")
    parser.add_argument("name", nargs="?", default="catnet_gp",
                        choices=sorted(CLASSIFIERS))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("gradient_conditioning: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load_library()
    batch = make_catnet_batch(
        2, batch=CLASSIFIERS[args.name][2], shape=classifier_shape(args.name),
        n_classes=CLASSIFIER_CLASSES.get(args.name, 2))
    tr = make_catnet_trainer(0, "32", name=args.name)
    names = list(tr.state.params)

    def gradient(ctx, weights, b):
        seed_dropout(tr.model, torch.Generator(device="cuda").manual_seed(9))
        with ctx():
            loss, _ = tr.loss_and_metrics(weights, b)
            grads = torch.autograd.grad(loss, [weights[k] for k in names],
                                        allow_unused=True)
        return {k: g.detach().double() for k, g in zip(names, grads)
                if g is not None}

    image = batch["image"]
    noise = torch.randn(image.shape, device=image.device, dtype=image.dtype,
                        generator=torch.Generator(
                            device=image.device).manual_seed(5))
    perturbed = dict(batch, image=image + PERTURBATION * image.std()
                     * noise)
    weights = tr.state.weights()
    runs = {
        "kernels": gradient(contextlib.nullcontext, weights, batch),
        "kernels_again": gradient(contextlib.nullcontext, weights, batch),
        "plain": gradient(plain_convs, weights, batch),
        "plain_perturbed": gradient(plain_convs, weights, perturbed),
    }
    w64 = {k: v.detach().double().requires_grad_(k in tr.state.params)
           for k, v in weights.items()}
    b64 = {k: v.double() if v.is_floating_point() else v
           for k, v in batch.items()}
    f64 = gradient(plain_convs, w64, b64)
    largest = max(float(g.abs().max()) for g in f64.values())
    held = [k for k, g in f64.items()
            if float(g.abs().max()) >= ROUNDING_GRADIENT * largest]

    def distance(a, b):
        num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in held)
        return (num / sum(float((b[k] ** 2).sum()) for k in held)) ** 0.5

    out = dict(
        name=args.name, held=len(held), left_out=len(f64) - len(held),
        kernels_vs_plain=distance(runs["kernels"], runs["plain"]),
        kernels_vs_kernels_again=distance(runs["kernels_again"],
                                          runs["kernels"]),
        perturbed_vs_plain=distance(runs["plain_perturbed"], runs["plain"]),
        kernels_vs_f64=distance(runs["kernels"], f64),
        plain_vs_f64=distance(runs["plain"], f64),
        perturbation=PERTURBATION)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
