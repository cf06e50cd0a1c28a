"""
Act/Dropout/Norm ordered block and its factory.

Counterpart of ``adell_mri_tpu/models/layers/adn.py``: ``InstanceNorm``,
``ActDropNorm`` and ``get_adn_fn``, for the norms the ported models use
(``"instance"``, affine off, as torch's InstanceNorm3d default).
Layout is channels-last; statistics run over the spatial axes.
"""

from typing import Callable, Optional

import torch
import torch.nn as nn

from adell_mri_torch.models.layers.activations import get_activation
from adell_mri_torch.models.layers.dropout import Dropout


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over the spatial axes, without
    affine parameters.

    The statistics follow the JAX package's rule: bf16/f16 inputs take
    single-pass f32 statistics (E[x^2] - E[x]^2, clamped at 0), where the
    f32 accumulator has 16 bits of headroom over the data; f32 inputs take
    the two-pass variance, which does not cancel when mean >> std. The
    normalisation itself runs in the input dtype."""

    def __init__(self, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon

    def forward(self, x):
        axes = tuple(range(1, x.dim() - 1))
        if x.dtype in (torch.bfloat16, torch.float16):
            xf = x.float()
            mean = xf.mean(dim=axes, keepdim=True)
            var = (xf * xf).mean(dim=axes, keepdim=True) - mean * mean
            var = var.clamp_min(0.0)
        else:
            mean = x.mean(dim=axes, keepdim=True)
            var = x.var(dim=axes, keepdim=True, unbiased=False)
        inv = torch.rsqrt(var + self.epsilon).to(x.dtype)
        return (x - mean.to(x.dtype)) * inv


class ActDropNorm(nn.Module):
    """Norm, then dropout, then activation: the JAX package's default
    "NDA" order, the one every call site uses. Dropout is the port's
    ``Dropout`` (explicit generator), active only in training mode."""

    def __init__(
        self,
        norm_fn: str = "instance",
        act_fn: str = "swish",
        dropout_param: float = 0.0,
        dropout_type: str = "dropout",
    ):
        super().__init__()
        if str(norm_fn).lower() != "instance":
            raise NotImplementedError(
                f"norm {norm_fn!r} is not ported yet (the port has "
                "'instance')"
            )
        if dropout_type != "dropout":
            raise NotImplementedError(
                f"dropout_type {dropout_type!r} is not ported yet"
            )
        self.norm = InstanceNorm()
        self.dropout = Dropout(dropout_param) if dropout_param > 0 else None
        self.act = get_activation(act_fn)

    def forward(self, x):
        x = self.norm(x)
        if self.dropout is not None:
            x = self.dropout(x)
        return self.act(x)


def get_adn_fn(
    norm_fn: str = "instance",
    act_fn: str = "swish",
    dropout_param: float = 0.0,
    dropout_type: str = "dropout",
) -> Callable[..., ActDropNorm]:
    """Returns an ActDropNorm constructor with baked arguments; the
    feature count is accepted for call-site parity with the JAX factory
    (instance norm has no per-feature parameters)."""
    if act_fn == "prelu":
        raise NotImplementedError("prelu ADNs are not ported yet")

    def ctor(_features: Optional[int] = None) -> ActDropNorm:
        return ActDropNorm(
            norm_fn=norm_fn,
            act_fn=act_fn,
            dropout_param=dropout_param,
            dropout_type=dropout_type,
        )

    return ctor
