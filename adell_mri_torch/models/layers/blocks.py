"""
Small building blocks of the model layers.

Counterpart of ``_tuple``, ``apply_adn``, ``GlobalPooling``, ``max_pool``,
``MLP`` and ``VGGConvolution`` in ``adell_mri_tpu/models/layers/blocks.py``,
on channels-last tensors.
"""

from typing import Optional, Sequence, Union

import torch.nn as nn
import torch.nn.functional as F

from adell_mri_torch.models.layers.adn import get_adn_fn
from adell_mri_torch.ops.conv import Conv3d, Pointwise


def _tuple(v, n: int):
    if isinstance(v, (list, tuple)):
        if len(v) != n:
            raise ValueError(f"expected length-{n} spec, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * n


def apply_adn(adn, x):
    return x if adn is None else adn(x)


class GlobalPooling(nn.Module):
    """Pooling over the spatial axes of ``[B, *S, C]``: max (the default,
    every classifier head's) or mean."""

    def __init__(self, mode: str = "max"):
        super().__init__()
        if mode not in ("max", "mean", "average"):
            raise NotImplementedError(f"pooling mode {mode!r}")
        self.mode = mode

    def forward(self, x):
        axes = tuple(range(1, x.dim() - 1))
        if self.mode == "max":
            return x.amax(dim=axes)
        return x.mean(dim=axes)


def max_pool(x, window: Union[int, Sequence[int]], padding: str = "VALID"):
    """Max pooling of ``[B, *S, C]`` with the stride of the window (flax's
    ``max_pool`` as the JAX package calls it). "VALID" drops a trailing
    remainder shorter than the window; "SAME" gives ``ceil(n / k)``
    outputs, padding as XLA does (``total // 2`` low, the rest high, at
    most ``k - 1`` in all) with -inf, which no window takes."""
    spatial = tuple(x.shape[1:-1])
    w = _tuple(window, len(spatial))
    if padding == "SAME":
        pads = []
        for n, k in zip(spatial, w):
            total = -(-n // k) * k - n
            pads.append((total // 2, total - total // 2))
        if any(p for lo_hi in pads for p in lo_hi):
            flat = [0, 0] + [p for lo_hi in reversed(pads) for p in lo_hi]
            x = F.pad(x, flat, value=float("-inf"))
            spatial = tuple(x.shape[1:-1])
    elif padding != "VALID":
        raise NotImplementedError(f"max_pool padding {padding!r}")
    out = [n // k for n, k in zip(spatial, w)]
    x = x[(slice(None),) + tuple(slice(0, o * k) for o, k in zip(out, w))]
    shape = [x.shape[0]]
    for o, k in zip(out, w):
        shape += [o, k]
    x = x.reshape(shape + [x.shape[-1]])
    return x.amax(dim=tuple(range(2, 2 * len(spatial) + 1, 2)))


def add_mlp(module: nn.Module, in_features: int, hidden_dims: Sequence[int],
            out_dim: Optional[int], adn_fn=None) -> int:
    """Registers on ``module`` Dense layers of ``hidden_dims``, each
    followed by ``adn_fn(width)``, then a Dense layer to ``out_dim`` (none
    when it is None), under the JAX tree's names (``Dense_{i}``,
    ``ActDropNorm_{i}``); returns the number of hidden layers, which
    ``run_mlp`` takes."""
    for i, h in enumerate(hidden_dims):
        module.add_module(f"Dense_{i}", Pointwise(in_features, h))
        if adn_fn is not None:
            module.add_module(f"ActDropNorm_{i}", adn_fn(h))
        in_features = h
    if out_dim is not None:
        module.add_module(f"Dense_{len(hidden_dims)}",
                          Pointwise(in_features, out_dim))
    return len(hidden_dims)


def run_mlp(module: nn.Module, n_hidden: int, x):
    """The forward of the layers ``add_mlp`` registered on ``module``."""
    for i in range(n_hidden):
        x = apply_adn(getattr(module, f"ActDropNorm_{i}", None),
                      getattr(module, f"Dense_{i}")(x))
    out = getattr(module, f"Dense_{n_hidden}", None)
    return x if out is None else out(x)


class MLP(nn.Module):
    """Dense layers of ``hidden_dims``, each followed by ``adn_fn(width)``,
    then a Dense layer to ``out_dim`` (``add_mlp``)."""

    def __init__(self, in_features: int, hidden_dims: Sequence[int],
                 out_dim: int, adn_fn=None):
        super().__init__()
        self.n_hidden = add_mlp(self, in_features, hidden_dims, out_dim,
                                adn_fn)

    def forward(self, x):
        return run_mlp(self, self.n_hidden, x)


class VGGConvolution(nn.Module):
    """A 3x3x3 SAME conv to ``first_depth`` channels and one to twice that,
    each followed by an ADN (``norm_fn``, ``act_fn``, no dropout), then a
    SAME max-pool of 2 (a spatial size of 1 stays 1). Both convs are K1's
    class. With ``ndim`` 2 (the JAX block takes the rank of its input)
    the convs are 3x3 and the pool 2x2. Module names are the JAX tree's:
    ``Conv_0``, ``ActDropNorm_0``, ``Conv_1``, ``ActDropNorm_1``."""

    def __init__(self, in_channels: int, first_depth: int,
                 norm_fn: str = "batch", act_fn: str = "relu",
                 ndim: int = 3):
        super().__init__()
        d = first_depth
        adn = get_adn_fn(norm_fn, act_fn)
        self.Conv_0 = Conv3d(in_channels, d, (3,) * ndim)
        self.ActDropNorm_0 = adn(d)
        self.Conv_1 = Conv3d(d, 2 * d, (3,) * ndim)
        self.ActDropNorm_1 = adn(2 * d)

    def forward(self, x):
        x = apply_adn(self.ActDropNorm_0, self.Conv_0(x))
        x = apply_adn(self.ActDropNorm_1, self.Conv_1(x))
        return max_pool(x, 2, padding="SAME")
