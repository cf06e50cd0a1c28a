"""
Resizing of channels-last feature maps, and ASPP.

Counterpart of ``resize_like`` and ``AtrousSpatialPyramidPooling`` in
``adell_mri_tpu/models/layers/multi_resolution.py``; ``resize_like`` is
``jax.image.resize``. Its ``linear`` method is separable and ANTIALIASED:
along an axis that shrinks, the triangle kernel is widened by the shrink
factor, so a 2x shrink weighs four neighbours (1/8, 3/8, 3/8, 1/8,
renormalised at the edges) and not two. ``F.interpolate`` has no
antialiased trilinear mode, so the per-axis weight matrix is built here as
``jax.image.resize`` builds it (half-pixel centres, columns normalised)
and applied along each axis whose size changes.

``resize_volume`` is the same resize for any array, with the ``cubic``
method as well: Keys' kernel with a = -0.5 over half-pixel centres,
antialiased and with its weights renormalised at the edges, as
``jax.image.resize`` computes it. Torch's ``bicubic`` (a = -0.75, clamped
edges) and its ``nearest`` (``floor(i * in / out)``) are other functions.
Its weights are computed on the host and applied as a fixed-order sum of
the few taps under each output, so the card and the CPU give the same
bits (a matrix product sums in an order each library picks).
"""

from functools import lru_cache

import numpy as np
import torch
import torch.nn as nn

from adell_mri_torch.models.layers.blocks import apply_adn
from adell_mri_torch.ops.conv import Conv3d, Pointwise


def _resize_weights(n_in: int, n_out: int, kernel, device=None,
                    inv_scale=None):
    """``[n_in, n_out]`` f32 weights of an antialiased resize of one axis
    with ``kernel`` (a function of the distance in input voxels)."""
    if inv_scale is None:
        inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (
        torch.arange(n_out, dtype=torch.float32, device=device) + 0.5
    ) * inv_scale - 0.5
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    x = (sample[None, :] - src[:, None]).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(
        total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0
    )
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def linear_resize_weights(n_in: int, n_out: int, device=None):
    """``[n_in, n_out]`` f32 weights of the antialiased linear resize of
    one axis."""
    return _resize_weights(n_in, n_out, lambda x: (1.0 - x).clamp_min(0.0),
                           device)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def cubic_resize_weights(n_in: int, n_out: int, device=None):
    """``[n_in, n_out]`` f32 weights of ``jax.image.resize``'s cubic
    resize of one axis (its sample positions: ``1 / (out / in)``)."""
    return _resize_weights(n_in, n_out, _keys_cubic, device,
                           inv_scale=1.0 / (n_out / n_in))


def _lanczos(radius: float):
    def kernel(x):
        y = radius * torch.sin(np.pi * x) * torch.sin(np.pi * x / radius)
        out = torch.where(
            x > 1e-3, y / torch.where(x != 0, np.pi ** 2 * x * x, 1.0), 1.0)
        return torch.where(x > radius, 0.0, out)

    return kernel


def lanczos_resize_weights(radius: int):
    """The ``[n_in, n_out]`` weights function of ``jax.image.resize``'s
    ``lanczos{radius}`` resize of one axis."""

    def weights(n_in: int, n_out: int, device=None):
        return _resize_weights(n_in, n_out, _lanczos(float(radius)), device,
                               inv_scale=1.0 / (n_out / n_in))

    return weights


def nearest_resize_index(n_in: int, n_out: int, device=None):
    """The input index of each output voxel of ``jax.image.resize``'s
    ``nearest``: ``floor((i + 0.5) * in / out)`` in f32 (torch's
    ``nearest-exact``)."""
    return torch.floor(
        (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
        * n_in / n_out
    ).long()


_WEIGHTS = {"linear": linear_resize_weights, "cubic": cubic_resize_weights}


@lru_cache(maxsize=64)
def _band(method: str, n_in: int, n_out: int):
    """The resize of one axis as taps: ``(index, weight)``, both ``[T,
    n_out]`` numpy arrays, tap ``t`` of output ``o`` reading input
    ``index[t, o]`` with ``weight[t, o]`` (zero where the band is
    shorter), for the T inputs that the widest output reads."""
    w = _WEIGHTS[method](n_in, n_out).numpy()
    nz = w != 0
    has = nz.any(0)
    first = np.where(has, nz.argmax(0), 0)
    last = np.where(has, n_in - 1 - nz[::-1].argmax(0), 0)
    taps = int((last - first).max()) + 1
    raw = first[None] + np.arange(taps)[:, None]
    index = np.minimum(raw, n_in - 1)
    weight = np.where(raw > last[None], 0.0,
                      np.take_along_axis(w, index, 0)).astype(np.float32)
    return index, weight


def resize_volume(x, shape, method: str = "linear"):
    """``jax.image.resize(x, shape, method)`` for ``method`` "linear",
    "cubic" or "nearest": each axis whose size changes is resized on its
    own, as a sum over the taps of ``_band`` in their order (or a nearest
    index). Linear and cubic compute in f32 and return f32 (as JAX
    promotes integers), nearest keeps the dtype."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.dim():
        raise ValueError(f"shape {shape} does not fit {tuple(x.shape)}")
    if method not in _WEIGHTS and method != "nearest":
        raise NotImplementedError(
            f"resize method {method!r} is not ported (linear, cubic, "
            "nearest)")
    if method != "nearest" and not x.is_floating_point():
        x = x.float()
    for axis, n_out in enumerate(shape):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        if method == "nearest":
            x = x.index_select(axis, nearest_resize_index(n_in, n_out,
                                                          x.device))
            continue
        index, weight = _band(method, n_in, n_out)
        # asynchronous copies: the host does not wait for the card
        index = torch.from_numpy(index).to(x.device, non_blocking=True)
        weight = torch.from_numpy(weight).to(x.device, x.dtype,
                                             non_blocking=True)
        bcast = [1] * x.dim()
        bcast[axis] = n_out
        out = None
        for t in range(index.shape[0]):
            term = x.index_select(axis, index[t]) * weight[t].reshape(bcast)
            out = term if out is None else out + term
        x = out
    return x


# the method names ``jax.image.resize`` takes, by the weights of each
_RESIZE_LIKE = {
    **dict.fromkeys(("linear", "bilinear", "trilinear", "triangle"),
                    linear_resize_weights),
    **dict.fromkeys(("cubic", "bicubic", "tricubic"), cubic_resize_weights),
    "lanczos3": lanczos_resize_weights(3),
    "lanczos5": lanczos_resize_weights(5),
}


def resize_like(x, target_shape_spatial, method: str = "linear"):
    """Resizes the spatial axes of channels-last ``x`` ``[B, *S, C]`` to
    ``target_shape_spatial`` with ``method``: "nearest", or any other name
    ``jax.image.resize`` takes ("linear" and its aliases, "cubic" and its
    aliases, "lanczos3", "lanczos5"), antialiased as there. Axes whose
    size stays are left alone."""
    target = tuple(int(t) for t in target_shape_spatial)
    if len(target) != x.dim() - 2:
        raise ValueError(
            f"target {target} does not fit the spatial axes of "
            f"{tuple(x.shape)}"
        )
    if method not in _RESIZE_LIKE and method != "nearest":
        raise NotImplementedError(
            f"resize method {method!r} is not ported (nearest, "
            f"{', '.join(_RESIZE_LIKE)})"
        )
    for axis, n_out in enumerate(target, start=1):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        if method == "nearest":
            x = x.index_select(axis, nearest_resize_index(n_in, n_out,
                                                          x.device))
        else:
            w = _RESIZE_LIKE[method](n_in, n_out, x.device).to(x.dtype)
            x = torch.movedim(
                torch.tensordot(x, w, dims=([axis], [0])), -1, axis
            )
    return x



class AtrousSpatialPyramidPooling(nn.Module):
    """ASPP (the JAX package's ``AtrousSpatialPyramidPooling``): per rate a
    3^3 conv at that dilation and an ADN, a branch of the spatial mean
    through a 1x1 conv broadcast back, all concatenated, then a 1x1
    projection and an ADN. Names are the flax tree's: ``Conv_{i}`` for the
    dilated convs, then the pooled branch's and the projection's;
    ``ActDropNorm_{i}`` in call order. The dilated convs are ``F.conv3d``,
    as XLA computes them in the JAX package."""

    def __init__(self, in_channels: int, out_channels: int,
                 rates=(1, 2, 4), adn_fn=None):
        super().__init__()
        self.n_rates = len(rates)
        for i, rate in enumerate(rates):
            self.add_module(f"Conv_{i}", Conv3d(
                in_channels, out_channels, (3, 3, 3),
                dilation=(rate,) * 3))
            self.add_module(f"ActDropNorm_{i}",
                            adn_fn(out_channels) if adn_fn else None)
        n = self.n_rates
        self.add_module(f"Conv_{n}", Pointwise(in_channels, out_channels))
        self.add_module(f"Conv_{n + 1}",
                        Pointwise(out_channels * (n + 1), out_channels))
        self.add_module(f"ActDropNorm_{n}",
                        adn_fn(out_channels) if adn_fn else None)

    def forward(self, x):
        n = self.n_rates
        branches = [
            apply_adn(getattr(self, f"ActDropNorm_{i}"),
                      getattr(self, f"Conv_{i}")(x))
            for i in range(n)
        ]
        g = x.mean(dim=tuple(range(1, x.dim() - 1)), keepdim=True)
        g = getattr(self, f"Conv_{n}")(g)
        branches.append(g.expand(x.shape[:-1] + (g.shape[-1],)))
        y = getattr(self, f"Conv_{n + 1}")(torch.cat(branches, -1))
        return apply_adn(getattr(self, f"ActDropNorm_{n}"), y)
