"""
Regularization layers.

Counterpart of ``UOut``, ``L2NormalizationLayer``, ``GRN`` and
``LayerScale`` in
``adell_mri_tpu/models/layers/regularization.py``, on channels-last
tensors. ``UOut`` draws from an explicit generator, as the port's
``Dropout`` does (``models/layers/dropout.py:seed_dropout`` hands it one).
"""

import torch
import torch.nn as nn


class UOut(nn.Module):
    """Multiplicative uniform noise ``x * (1 + U(-beta, beta))`` in
    training mode; the identity in eval mode."""

    def __init__(self, beta: float = 0.0):
        super().__init__()
        self.beta = float(beta)
        self.generator = None

    def draw(self, x):
        """The noise ``U(-beta, beta)`` of ``x``'s shape, in its dtype."""
        u = torch.rand(x.shape, device=x.device, generator=self.generator)
        return (u * (2 * self.beta) - self.beta).to(x.dtype)

    def forward(self, x):
        if not self.training or self.beta == 0:
            return x
        return x * (1.0 + self.draw(x))

    def extra_repr(self):
        return f"beta={self.beta}"


class L2NormalizationLayer(nn.Module):
    """Unit norm along the last axis, the norm held at ``eps`` at least."""

    def __init__(self, eps: float = 1e-8):
        super().__init__()
        self.eps = eps

    def forward(self, x):
        return x / torch.linalg.vector_norm(
            x, dim=-1, keepdim=True).clamp_min(self.eps)


class GRN(nn.Module):
    """Global response normalization (ConvNeXt-V2): ``gx`` the L2 norm of
    each channel over the spatial axes, ``nx = gx / (mean_c(gx) + 1e-6)``,
    ``gamma * (x * nx) + bias + x``; ``gamma`` and ``bias`` start at 0."""

    def __init__(self, features: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        axes = tuple(range(1, x.dim() - 1))
        gx = torch.sqrt(torch.sum(x * x, dim=axes, keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return self.gamma * (x * nx) + self.bias + x


class LayerScale(nn.Module):
    """A learnt per-channel scale (``layer_scale``, ``init_value`` at
    first)."""

    def __init__(self, features: int, init_value: float = 1e-6):
        super().__init__()
        self.layer_scale = nn.Parameter(torch.full((features,), init_value))

    def forward(self, x):
        return x * self.layer_scale
