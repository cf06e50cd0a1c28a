"""
Act/Dropout/Norm ordered block and its factory.

Counterpart of ``adell_mri_tpu/models/layers/adn.py``: ``InstanceNorm``,
``GlobalBatchNorm``, ``ActDropNorm`` and ``get_adn_fn``, for the norms the
ported models use: ``"instance"`` (affine off, as torch's InstanceNorm3d
default) and ``"batch"`` (the classifiers' default), on channels-last
tensors of any rank, ``[B, F]`` included.

Batch norm keeps its running statistics as buffers (``mean``, ``var``),
the JAX package's ``batch_stats`` collection. A training forward does not
write them: each ``GlobalBatchNorm`` leaves its updated statistics in
``new_stats``, and the train step collects them (``pop_batch_stats``) and
returns them, as the JAX step returns its mutated collection, so nothing
is written in place inside the autograd graph.
"""

from typing import Callable, Dict, Optional

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


class GlobalBatchNorm(nn.Module):
    """Batch normalization with the JAX package's rule.

    Statistics run over every axis but the last (channels-last), with the
    biased variance: bf16/f16 inputs take single-pass f32 statistics
    rounded to the input dtype, f32 inputs two passes. In training the
    batch's statistics normalize and the running averages move to
    ``momentum * running + (1 - momentum) * batch`` in f32, left in
    ``new_stats`` (detached) for the step to collect. In eval the running
    statistics normalize, in f32, and the result returns in the input
    dtype. Fresh statistics are (0, 1), what the JAX module falls back to
    at eval with one element per feature and no statistics."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.new_stats = None

    def forward(self, x):
        if not self.training:
            y = (x - self.mean) * torch.rsqrt(self.var + self.epsilon)
            return (y * self.weight + self.bias).to(x.dtype)
        axes = tuple(range(x.dim() - 1))
        if x.dtype in (torch.bfloat16, torch.float16):
            xf = x.float()
            mean32 = xf.mean(dim=axes)
            var = ((xf * xf).mean(dim=axes) - mean32 * mean32).clamp_min(
                0.0).to(x.dtype)
            mean = mean32.to(x.dtype)
        else:
            mean = x.mean(dim=axes)
            var = x.var(dim=axes, unbiased=False)
        m = self.momentum
        self.new_stats = (
            m * self.mean + (1 - m) * mean.detach().float(),
            m * self.var + (1 - m) * var.detach().float(),
        )
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.weight + self.bias


def batch_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The running statistics of ``model``'s batch norms by their
    ``state_dict`` names (the JAX package's ``batch_stats`` collection)."""
    return {
        f"{name}.{stat}": getattr(module, stat)
        for name, module in model.named_modules()
        if isinstance(module, GlobalBatchNorm)
        for stat in ("mean", "var")
    }


def pop_batch_stats(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The statistics the last training forward of ``model`` computed, by
    the names of ``batch_stats``, taken out of the modules."""
    out = {}
    for name, module in model.named_modules():
        if isinstance(module, GlobalBatchNorm) and module.new_stats:
            out[f"{name}.mean"], out[f"{name}.var"] = module.new_stats
            module.new_stats = None
    return out


class ActDropNorm(nn.Module):
    """Norm, then dropout, then activation: the JAX package's default
    "NDA" order, the one every call site uses. Dropout is the port's
    ``Dropout`` (explicit generator), active only in training mode. The
    norm carries the JAX tree's name (``GlobalBatchNorm_0``, whose
    parameters and statistics ``from_flax`` maps; instance norm has
    neither)."""

    def __init__(
        self,
        features: Optional[int] = None,
        norm_fn: str = "instance",
        act_fn: str = "swish",
        dropout_param: float = 0.0,
        dropout_type: str = "dropout",
    ):
        super().__init__()
        norm_fn = str(norm_fn).lower()
        if norm_fn == "batch":
            if features is None:
                raise ValueError("a batch-norm ADN needs its feature count")
            self.norm_name = "GlobalBatchNorm_0"
            norm = GlobalBatchNorm(features)
        elif norm_fn == "instance":
            self.norm_name = "InstanceNorm_0"
            norm = InstanceNorm()
        else:
            raise NotImplementedError(
                f"norm {norm_fn!r} is not ported yet (the port has "
                "'instance' and 'batch')"
            )
        if dropout_type != "dropout":
            raise NotImplementedError(
                f"dropout_type {dropout_type!r} is not ported yet"
            )
        self.add_module(self.norm_name, norm)
        self.dropout = Dropout(dropout_param) if dropout_param > 0 else None
        self.act = get_activation(act_fn)

    def forward(self, x):
        x = self._modules[self.norm_name](x)
        if self.dropout is not None:
            x = self.dropout(x)
        return self.act(x)


def get_adn_fn(
    norm_fn: str = "instance",
    act_fn: str = "swish",
    dropout_param: float = 0.0,
    dropout_type: str = "dropout",
) -> Callable[..., ActDropNorm]:
    """Returns an ActDropNorm constructor with baked arguments; it takes
    the feature count, which batch norm needs for its parameters."""
    if act_fn == "prelu":
        raise NotImplementedError("prelu ADNs are not ported yet")

    def ctor(features: Optional[int] = None) -> ActDropNorm:
        return ActDropNorm(
            features,
            norm_fn=norm_fn,
            act_fn=act_fn,
            dropout_param=dropout_param,
            dropout_type=dropout_type,
        )

    return ctor
