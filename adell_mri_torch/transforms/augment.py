"""
TrivialAugment on the device: the 27-op registry and its workhorse.

The port's copy of ``adell_mri_tpu/transforms/augment.py``: the op lists,
the per-axis smoothing and sharpening, coarse dropout, the k-space spike,
the one-axis affine ops, ``build_registry`` (27 ops in the JAX package's
order: nine fixed ops, then for each of x, y and z smooth, sharpen,
rotate, translate, shear and scale) and ``AugmentationWorkhorse``.

Each op is an ``AugOp``: ``draw(generator, x)`` returns the op's random
draws (a tuple of tensors on ``x``'s device, not scaled by the magnitude)
and ``core(x, mag, *draws)`` computes it, so a test can hand the core the
draws of the JAX op. Uniform draws are in [0, 1) and the core maps them to
the op's range as ``jax.random.uniform`` does (``u (hi - lo) + lo``). ``mag`` is a number or a 0-dim tensor in [0, 1]. The
ops compute in f32 and return ``x``'s dtype.
"""

import math
from typing import Callable, Dict, List, NamedTuple, Sequence

import torch

from adell_mri_torch.models.layers.multi_resolution import resize_volume
from adell_mri_torch.transforms import intensity as I
from adell_mri_torch.transforms import spatial as S

generic_augments: List[str] = [
    "gaussian_noise",
    "shift_intensity",
    "scale_intensity",
    "contrast",
    "gaussian_smooth_x",
    "gaussian_smooth_y",
    "gaussian_smooth_z",
    "gaussian_sharpen_x",
    "gaussian_sharpen_y",
    "gaussian_sharpen_z",
    "coarse_dropout",
]
mri_specific_augments: List[str] = [
    "rbf",
    "gibbs_noise",
    "spike_noise",
    "rician_noise",
]
spatial_augments: List[str] = [
    "rotate_x",
    "rotate_y",
    "rotate_z",
    "translate_x",
    "translate_y",
    "translate_z",
    "shear_x",
    "shear_y",
    "shear_z",
    "scale_x",
    "scale_y",
    "scale_z",
]

COARSE_DROPOUT_GRID = 8
SMOOTH_RADIUS = 3


class AugOp(NamedTuple):
    draw: Callable  # (generator, x) -> tuple of tensors
    core: Callable  # (x, mag, *draws) -> x


def _no_draw(generator, x):
    return ()


def _uniform(generator, x, shape=()):
    return torch.rand(shape, generator=generator, device=x.device)


def _normal(generator, x, shape=None):
    return torch.randn(x.shape if shape is None else shape,
                       generator=generator, device=x.device)


def _one_uniform(generator, x):
    return (_uniform(generator, x),)


def _smooth_axis(x, mag, axis: int):
    """Smooths one axis only, sigma ``0.3 + mag``, 7 taps."""
    sigma = I._scalar(mag, x.device) + 0.3
    taps = I._gaussian_kernel1d(sigma, SMOOTH_RADIUS)
    return I.smooth_axis(x.float(), taps, axis).to(x.dtype)


def _sharpen_axis(x, mag, axis: int):
    xf = x.float()
    return (xf + (0.5 + mag) * (xf - _smooth_axis(xf, 0.5, axis))).to(
        x.dtype)


def _coarse_dropout(x, mag, u):
    """Zeroes the voxels of the coarse cells (``u`` [8, 8, 8, 1] uniform)
    below ``0.1 (1 + mag)``, nearest-resized to the volume."""
    keep = (u > 0.1 * (1 + mag)).float()
    mask = resize_volume(keep, tuple(x.shape[:-1]) + (1,), "nearest")
    return (x.float() * mask).to(x.dtype)


def _draw_spike(generator, x):
    """One position of the spectrum, uniform on each spatial axis."""
    ndim = x.dim() - 1
    return (torch.stack([
        torch.randint(0, x.shape[d], (), generator=generator,
                      device=x.device)
        for d in range(ndim)
    ]),)


def _spike_noise(x, mag, pos):
    """Adds one k-space spike at ``pos`` (the same position in every
    channel) of magnitude ``mean|k| e^(4 + 4 mag)`` (RandKSpaceSpikeNoise
    analogue); ``torch.fft`` computes in f32."""
    ndim = x.dim() - 1
    axes = tuple(range(ndim))
    kk = torch.fft.fftn(x.float(), dim=axes)
    log_mag = torch.log(torch.clamp_min(kk.abs().mean(), 1e-6)) + (
        4.0 + 4.0 * mag)
    spike = torch.exp(log_mag)
    strides, acc = [], 1
    for d in reversed(range(ndim)):
        strides.insert(0, acc)
        acc *= x.shape[d]
    flat_idx = sum(pos[d] * strides[d] for d in range(ndim))
    # a one-hot row, not an indexed write: no host sync for the index
    hot = torch.arange(acc, device=x.device) == flat_idx
    kflat = kk.reshape(acc, x.shape[-1])
    kflat = kflat + (hot.to(kflat.dtype) * spike)[:, None]
    out = torch.fft.ifftn(kflat.reshape(kk.shape), dim=axes)
    return out.real.to(x.dtype)


def _draw_sign(generator, x):
    return (_uniform(generator, x) < 0.5,)


def _affine_one(x, mag, positive, kind: str, axis: int):
    """One-axis rotation (by ``mag pi / 6``), translation (``0.1 mag`` of
    the axis), shear (``0.3 mag``, the entry ``axis (ndim - 1)`` of the
    row-major off-diagonals) or scale (``1 + 0.3 mag``) about the centre,
    its sign set by ``positive``; the rotation takes angle
    ``min(axis, n_angles - 1)``."""
    ndim = x.dim() - 1
    shape = tuple(x.shape[:-1])
    dev = x.device
    n_angles = 1 if ndim == 2 else 3
    angles = torch.zeros(n_angles, device=dev)
    scales = torch.ones(ndim, device=dev)
    shears = torch.zeros(ndim * (ndim - 1), device=dev)
    trans = torch.zeros(ndim, device=dev)
    sign = torch.where(positive, 1.0, -1.0)
    if kind == "rotate":
        angles[min(axis, n_angles - 1)] = sign * mag * math.pi / 6
    elif kind == "translate":
        trans[axis] = sign * mag * 0.1 * shape[axis]
    elif kind == "shear":
        shears[axis * (ndim - 1)] = sign * mag * 0.3
    elif kind == "scale":
        scales[axis] = 1.0 + sign * mag * 0.3
    m = (
        S.center_matrix(shape, +1.0, dev)
        @ S.rotation_matrix(ndim, angles)
        @ S.scale_shear_matrix(ndim, scales, shears)
        @ S.center_matrix(shape, -1.0, dev)
    )
    m[:ndim, ndim] += trans
    return S.warp_affine(x, m).to(x.dtype)


def _contrast(x, mag, u):
    mag = I._scalar(mag, x.device)
    lo = 1.0 / (1.0 + 2.0 * mag + 1e-6)
    hi = 1.0 + 2.0 * mag
    return I.contrast_gamma(x, u * (hi - lo) + lo)


def _gibbs(x, mag, u):
    mag = I._scalar(mag, x.device)
    lo = 1.0 - 0.9 * mag
    hi = 1.0 - 0.5 * mag + 1e-3
    return I.truncate_kspace(x, u * (hi - lo) + lo)


def build_registry(ndim: int = 3) -> Dict[str, AugOp]:
    """Every op of the registry, by name, in the JAX package's order."""
    grid = COARSE_DROPOUT_GRID
    reg: Dict[str, AugOp] = {
        "gaussian_noise": AugOp(
            lambda g, x: (_normal(g, x),),
            lambda x, m, n: I.gaussian_noise(None, x, m, noise=n)),
        "shift_intensity": AugOp(
            _one_uniform,
            lambda x, m, u: (x.float() + (u - 0.5) * m).to(x.dtype)),
        "scale_intensity": AugOp(
            _one_uniform,
            lambda x, m, u: (x.float() * (1.0 + (u - 0.5) * m)).to(x.dtype)),
        "contrast": AugOp(_one_uniform, _contrast),
        "coarse_dropout": AugOp(
            lambda g, x: (_uniform(g, x, (grid,) * ndim + (1,)),),
            _coarse_dropout),
        "rbf": AugOp(
            lambda g, x: (_normal(g, x, (4,) * ndim + (1,)),),
            lambda x, m, n: I.apply_bias_field(x, n * (0.3 * m))),
        "gibbs_noise": AugOp(_one_uniform, _gibbs),
        "spike_noise": AugOp(_draw_spike, _spike_noise),
        "rician_noise": AugOp(
            lambda g, x: (_normal(g, x), _normal(g, x)),
            lambda x, m, n1, n2: I.rician(x, n1, n2, 0.3 * m)),
    }
    for d, ax in enumerate("xyz"[:ndim]):
        reg[f"gaussian_smooth_{ax}"] = AugOp(
            _no_draw, lambda x, m, d=d: _smooth_axis(x, m, d))
        reg[f"gaussian_sharpen_{ax}"] = AugOp(
            _no_draw, lambda x, m, d=d: _sharpen_axis(x, m, d))
        for kind in ("rotate", "translate", "shear", "scale"):
            reg[f"{kind}_{ax}"] = AugOp(
                _draw_sign,
                lambda x, m, s, kind=kind, d=d: _affine_one(x, m, s, kind,
                                                            d))
    return reg


class AugmentationWorkhorse:
    """TrivialAugment (AugmentationWorkhorsed's analogue): each call
    applies ``n_transforms`` ops, each chosen uniformly from the registry
    with a magnitude uniform in [0, 1), as the JAX package's does. The
    choice is drawn from a host ``torch.Generator`` seeded with ``seed``
    (the i-th call takes its i-th draws), so the host knows which op runs
    and runs that one alone, without a host sync; the magnitude and the
    op's own draws come from the device generator."""

    def __init__(
        self,
        augmentations: Sequence[str] = None,
        n_transforms: int = 1,
        ndim: int = 3,
        seed: int = 0,
    ):
        registry = build_registry(ndim)
        if augmentations is None:
            augmentations = list(registry)
        self.names = [a for a in augmentations if a in registry]
        self.ops = [registry[n] for n in self.names]
        self.n_transforms = n_transforms
        self.choice_generator = torch.Generator().manual_seed(seed)

    def draw(self, generator, x):
        """``n_transforms`` picks (op index, magnitude, the op's draws)."""
        picks = []
        for _ in range(self.n_transforms):
            index = int(torch.randint(len(self.ops), (),
                                      generator=self.choice_generator))
            mag = torch.rand((), generator=generator, device=x.device)
            picks.append((index, mag, self.ops[index].draw(generator, x)))
        return picks

    def apply(self, x, picks):
        for index, mag, draws in picks:
            x = self.ops[index].core(x, mag, *draws)
        return x

    def __call__(self, generator, x):
        return self.apply(x, self.draw(generator, x))
