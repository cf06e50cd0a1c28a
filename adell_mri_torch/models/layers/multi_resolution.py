"""
Resizing of channels-last feature maps.

Counterpart of ``resize_like`` in
``adell_mri_tpu/models/layers/multi_resolution.py``, which is
``jax.image.resize``. Its ``linear`` method is separable and ANTIALIASED:
along an axis that shrinks, the triangle kernel is widened by the shrink
factor, so a 2x shrink weighs four neighbours (1/8, 3/8, 3/8, 1/8,
renormalised at the edges) and not two. ``F.interpolate`` has no
antialiased trilinear mode, so the per-axis weight matrix is built here as
``jax.image.resize`` builds it (half-pixel centres, columns normalised)
and applied along each axis whose size changes.
"""

import torch


def linear_resize_weights(n_in: int, n_out: int, device=None):
    """``[n_in, n_out]`` f32 weights of the antialiased linear resize of
    one axis."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (
        torch.arange(n_out, dtype=torch.float32, device=device) + 0.5
    ) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    x = (sample[None, :] - src[:, None]).abs() / kernel_scale
    w = (1.0 - x).clamp_min(0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(
        total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0
    )
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_like(x, target_shape_spatial, method: str = "linear"):
    """Resizes the spatial axes of channels-last ``x`` ``[B, *S, C]`` to
    ``target_shape_spatial`` with ``method`` "linear" (antialiased) or
    "nearest". Axes whose size stays are left alone."""
    target = tuple(int(t) for t in target_shape_spatial)
    if len(target) != x.dim() - 2:
        raise ValueError(
            f"target {target} does not fit the spatial axes of "
            f"{tuple(x.shape)}"
        )
    if method not in ("linear", "nearest"):
        raise NotImplementedError(
            f"resize method {method!r} is not ported (linear, nearest)"
        )
    for axis, n_out in enumerate(target, start=1):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        if method == "nearest":
            offsets = torch.floor(
                (torch.arange(n_out, dtype=torch.float32, device=x.device)
                 + 0.5) * n_in / n_out
            ).long()
            x = x.index_select(axis, offsets)
        else:
            w = linear_resize_weights(n_in, n_out, x.device).to(x.dtype)
            x = torch.movedim(
                torch.tensordot(x, w, dims=([axis], [0])), -1, axis
            )
    return x
