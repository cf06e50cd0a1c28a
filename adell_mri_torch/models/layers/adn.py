"""
Act/Dropout/Norm ordered block and its factory.

Counterpart of ``adell_mri_tpu/models/layers/adn.py``: ``InstanceNorm``,
``GlobalBatchNorm``, ``GroupNorm``, ``make_norm``, ``ActDropNorm`` and
``get_adn_fn``, with every norm of ``make_norm``: ``"instance"`` (affine
off, as torch's InstanceNorm3d default), ``"instance_affine"``,
``"batch"`` (the classifiers' default), ``"layer"`` (flax's LayerNorm over
the channels), ``"group"`` and ``"identity"``/``"none"``, on channels-last
tensors of any rank, ``[B, F]`` included; the prelu activation (one
learnable slope) and ``uout`` dropout.

Batch norm keeps its running statistics as buffers (``mean``, ``var``),
the JAX package's ``batch_stats`` collection. A training forward does not
write them: each ``GlobalBatchNorm`` leaves its updated statistics in
``new_stats``, and the train step collects them (``pop_batch_stats``) and
returns them, as the JAX step returns its mutated collection, so nothing
is written in place inside the autograd graph. ``batch_statistics_mode``
makes eval-mode batch norms normalize by the batch's own statistics, as
the JAX modules do when applied without their ``batch_stats``.
"""

import contextlib
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from adell_mri_torch.models.layers.activations import get_activation
from adell_mri_torch.models.layers.dropout import Dropout
from adell_mri_torch.models.layers.regularization import UOut


def _stats(x, axes, keepdim=False):
    """(mean, var) of ``x`` over ``axes`` by the JAX package's rule:
    bf16/f16 inputs take single-pass f32 statistics (E[x^2] - E[x]^2,
    clamped at 0), f32 inputs the two-pass biased variance."""
    if x.dtype in (torch.bfloat16, torch.float16):
        xf = x.float()
        mean = xf.mean(dim=axes, keepdim=keepdim)
        var = (xf * xf).mean(dim=axes, keepdim=keepdim) - mean * mean
        return mean, var.clamp_min(0.0)
    return (x.mean(dim=axes, keepdim=keepdim),
            x.var(dim=axes, keepdim=keepdim, unbiased=False))


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over the spatial axes, with a
    per-channel scale and bias when ``affine`` (``instance_affine``).

    The statistics follow the JAX package's rule: bf16/f16 inputs take
    single-pass f32 statistics (E[x^2] - E[x]^2, clamped at 0), where the
    f32 accumulator has 16 bits of headroom over the data; f32 inputs take
    the two-pass variance, which does not cancel when mean >> std. The
    normalisation itself runs in the input dtype."""

    def __init__(self, features: Optional[int] = None,
                 epsilon: float = 1e-5, affine: bool = False):
        super().__init__()
        self.epsilon = epsilon
        if affine:
            if features is None:
                raise ValueError("an affine instance norm needs its width")
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        self.affine = affine

    def forward(self, x):
        mean, var = _stats(x, tuple(range(1, x.dim() - 1)), keepdim=True)
        inv = torch.rsqrt(var + self.epsilon).to(x.dtype)
        y = (x - mean.to(x.dtype)) * inv
        if self.affine:
            y = y * self.weight + self.bias
        return y


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
    at eval with one element per feature and no statistics.

    With ``batch_statistics`` set (``batch_statistics_mode``) an eval-mode
    forward normalizes by the batch's statistics and leaves the averages
    alone, as the JAX module applied without ``batch_stats`` does; where a
    feature has one element to reduce it takes (0, 1) instead."""

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
        self.batch_statistics = False

    def forward(self, x):
        if not self.training and not self.batch_statistics:
            y = (x - self.mean) * torch.rsqrt(self.var + self.epsilon)
            return (y * self.weight + self.bias).to(x.dtype)
        if not self.training and x[..., 0].numel() == 1:
            return x * (1.0 + self.epsilon) ** -0.5 * self.weight + self.bias
        mean, var = _stats(x, tuple(range(x.dim() - 1)))
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        if self.training:
            m = self.momentum
            self.new_stats = (
                m * self.mean + (1 - m) * mean.detach().float(),
                m * self.var + (1 - m) * var.detach().float(),
            )
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.weight + self.bias


def statistics_to_f32(model: nn.Module) -> nn.Module:
    """Puts ``model``'s running statistics back in f32 after a cast of the
    whole model (``model.to(torch.bfloat16)``): the precision policy
    casts the weights, never the statistics. Returns ``model``."""
    for m in model.modules():
        if isinstance(m, GlobalBatchNorm):
            m.mean, m.var = m.mean.float(), m.var.float()
    return model


@contextlib.contextmanager
def batch_statistics_mode(model: nn.Module):
    """Within the block ``model``'s batch norms in eval mode normalize by
    each batch's statistics (``GlobalBatchNorm.batch_statistics``)."""
    norms = [m for m in model.modules() if isinstance(m, GlobalBatchNorm)]
    for m in norms:
        m.batch_statistics = True
    try:
        yield model
    finally:
        for m in norms:
            m.batch_statistics = False


class GroupNorm(nn.Module):
    """Group normalization with the JAX package's group count: ``C // 8``
    groups when 8 divides C, else the largest of 4, 2 and 1 that divides
    it; adjacent channels share a group. Statistics by the instance norm's
    rule, eps 1e-6, then a per-channel scale and bias."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.groups = (features // 8 if features % 8 == 0
                       else next(g for g in (4, 2, 1) if features % g == 0))
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        c = x.shape[-1]
        xg = x.reshape(x.shape[0], -1, self.groups, c // self.groups)
        mean, var = _stats(xg, (1, 3), keepdim=True)
        inv = torch.rsqrt(var + self.epsilon).to(x.dtype)
        y = (xg - mean.to(x.dtype)) * inv
        return y.reshape(x.shape) * self.weight + self.bias


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the last axis: statistics in f32 (the
    fast variance ``E[x^2] - E[x]^2`` clamped at 0 when
    ``fast_variance``, else two passes), ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias``, returned in the input's dtype."""

    def __init__(self, features: int, epsilon: float = 1e-6,
                 fast_variance: bool = True):
        super().__init__()
        self.epsilon = epsilon
        self.fast_variance = fast_variance
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        if self.fast_variance:
            var = ((xf * xf).mean(-1, keepdim=True)
                   - mean * mean).clamp_min(0.0)
        else:
            var = (xf - mean).square().mean(-1, keepdim=True)
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


def make_norm(norm_fn: str, features: Optional[int] = None,
              spatial_dim: int = 3):
    """``(name, module)`` of the norm ``norm_fn`` at width ``features``, the
    name being the JAX tree's (``None`` for the identity)."""
    norm_fn = str(norm_fn or "identity").lower()
    if norm_fn in ("identity", "none"):
        return None, None
    if norm_fn == "instance":
        return "InstanceNorm_0", InstanceNorm()
    if features is None:
        raise ValueError(f"a {norm_fn!r} norm needs its feature count")
    if norm_fn == "batch":
        return "GlobalBatchNorm_0", GlobalBatchNorm(features)
    if norm_fn == "instance_affine":
        return "InstanceNorm_0", InstanceNorm(features, affine=True)
    if norm_fn == "layer":
        # the reference's channels-first LayerNorm takes eps 1e-6 on
        # spatial tensors, torch.nn.LayerNorm 1e-5 in 1D; both two-pass
        return "LayerNorm_0", LayerNorm(
            features, 1e-5 if spatial_dim == 1 else 1e-6,
            fast_variance=False)
    if norm_fn == "group":
        return "GroupNorm_0", GroupNorm(features)
    raise NotImplementedError(f"norm {norm_fn!r}")


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
    ``Dropout`` (or ``UOut`` for ``dropout_type="uout"``; both draw from an
    explicit generator), active only in training mode. The norm carries
    the JAX tree's name (``GlobalBatchNorm_0``, ``LayerNorm_0``,
    ``GroupNorm_0``, ``InstanceNorm_0``), whose parameters and statistics
    ``from_flax`` maps; ``"prelu"`` is a leaky ReLU whose one slope
    (``prelu``, shape (1,), 0.25 at first) is learnt, as torch's
    ``PReLU``."""

    def __init__(
        self,
        features: Optional[int] = None,
        norm_fn: str = "instance",
        act_fn: str = "swish",
        dropout_param: float = 0.0,
        dropout_type: str = "dropout",
        spatial_dim: int = 3,
    ):
        super().__init__()
        self.norm_name, norm = make_norm(norm_fn, features, spatial_dim)
        if norm is not None:
            self.add_module(self.norm_name, norm)
        if dropout_type not in ("dropout", "uout"):
            raise NotImplementedError(
                f"dropout_type {dropout_type!r} (the port has 'dropout' "
                "and 'uout')")
        self.dropout = None
        if dropout_param > 0:
            self.dropout = (UOut(dropout_param) if dropout_type == "uout"
                            else Dropout(dropout_param))
        if act_fn == "prelu":
            self.prelu = nn.Parameter(torch.full((1,), 0.25))
            self.act = None
        else:
            self.act = get_activation(act_fn)

    def forward(self, x):
        if self.norm_name is not None:
            x = self._modules[self.norm_name](x)
        if self.dropout is not None:
            x = self.dropout(x)
        if self.act is None:
            return torch.where(x >= 0, x, self.prelu.to(x.dtype) * x)
        return self.act(x)


def get_adn_fn(
    norm_fn: str = "instance",
    act_fn: str = "swish",
    dropout_param: float = 0.0,
    dropout_type: str = "dropout",
    spatial_dim: int = 3,
) -> Callable[..., ActDropNorm]:
    """Returns an ActDropNorm constructor with baked arguments; it takes
    the feature count, which the norms with parameters need."""

    def ctor(features: Optional[int] = None) -> ActDropNorm:
        return ActDropNorm(
            features,
            norm_fn=norm_fn,
            act_fn=act_fn,
            dropout_param=dropout_param,
            dropout_type=dropout_type,
            spatial_dim=spatial_dim,
        )

    return ctor
