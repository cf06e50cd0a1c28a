"""
Segmentation losses, as plain torch functions on channels-last tensors.

Counterpart of ``adell_mri_tpu/models/segmentation/losses.py``: the binary
and categorical members of ``loss_factory`` and ``CompoundLoss``, with the
reference's arithmetic kept as the JAX package keeps it:

- ``binary_focal_loss`` modulates the positive term by ``pred**gamma``;
- ``generalised_dice_score`` adds ``smooth`` per voxel inside the
  denominator sum and applies class weights to numerator and denominator;
- the categorical CE target is ``t*(1-ls) + 1/C``, even without label
  smoothing;
- ``mc_focal_tversky_loss`` carries a double ``+1`` in the denominator;
- ``unified_focal_loss`` hands ``weight`` to the focal ``gamma`` and
  ``1-gamma`` to its ``alpha``.

Binary: ``pred`` are probabilities [B, *S, 1] or [B, *S], ``target`` {0,1}
of the same (broadcastable) shape. Multiclass: ``pred`` softmax
probabilities [B, *S, C], ``target`` class indices [B, *S] or one-hot
[B, *S, C]. Every loss reduces to a scalar, the batch mean.
"""

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

eps = 1e-6
FOCAL_DEFAULT = {"alpha": None, "gamma": 1}
TVERSKY_DEFAULT = {"alpha": 1, "beta": 1, "gamma": 1}


def _flatten_binary(pred, target):
    if pred.dim() == target.dim() + 1 and pred.shape[-1] == 1:
        pred = pred[..., 0]
    elif target.dim() == pred.dim() + 1 and target.shape[-1] == 1:
        target = target[..., 0]
    b = pred.shape[0]
    return pred.reshape(b, -1), target.reshape(b, -1).to(pred.dtype)


def _mc_flat(pred, target):
    """[B, *S, C] (+ int/one-hot target) -> ([B, V, C], [B, V, C])."""
    n_classes = pred.shape[-1]
    if target.shape != pred.shape:
        target = F.one_hot(target.long(), n_classes)
    b = pred.shape[0]
    return (
        pred.reshape(b, -1, n_classes),
        target.reshape(b, -1, n_classes).to(pred.dtype),
    )


def _as_tensor(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


# -- binary ------------------------------------------------------------------


def binary_cross_entropy(
    pred, target, weight=1.0, scale=1.0, label_smoothing=0.0, eps=eps
):
    p, t = _flatten_binary(pred, target)
    t = t * (1 - label_smoothing) + label_smoothing / 2
    a = weight * t * torch.log(p + eps)
    b = (1 - t) * torch.log(1 - p + eps)
    return torch.mean(-torch.mean((a + b) * scale, dim=1))


def binary_focal_loss(
    pred,
    target,
    gamma=1.0,
    alpha=1.0,
    threshold=0.5,
    scale=1.0,
    label_smoothing=0.0,
    eps=eps,
):
    """The positive term's factor is ``pred**gamma``, as in the
    reference."""
    if alpha is None:
        alpha = 1.0
    p, t = _flatten_binary(pred, target)
    p = p.clamp_min(eps)
    p_inv = (1 - p).clamp_min(eps)
    t = (t > threshold).to(p.dtype)
    t = t * (1 - label_smoothing) + label_smoothing / 2
    loss = (
        -(
            alpha * (p**gamma) * torch.log(p) * t
            + (p_inv**gamma) * torch.log(p_inv) * (1 - t)
        )
        * scale
    )
    return torch.mean(torch.mean(loss, dim=-1))


def generalised_dice_score(
    pred, target, weight=None, smooth=0.0, scale=1.0, eps=eps
):
    """On [B, C, V] operands; returns [B]. ``smooth`` adds per voxel in
    the denominator; ``weight`` (scalar or [C]) multiplies both class
    sums."""
    w = torch.ones((), dtype=pred.dtype, device=pred.device)
    if weight is not None:
        w = _as_tensor(weight, pred)
    if w.dim() == 1:
        w = w[None]
    num = torch.sum(
        w * torch.sum((target * pred * scale).clamp_min(0.0), -1), -1
    )
    den = torch.sum(
        w * torch.sum(((target + pred + smooth) * scale).clamp_min(eps), -1),
        -1,
    )
    return num / den


def binary_generalized_dice_loss(
    pred, target, weight=1.0, smooth=1.0, scale=1.0, eps=eps
):
    """``1 - 2 * gds``."""
    p, t = _flatten_binary(pred, target)
    gds = generalised_dice_score(
        p[:, None, :], t[:, None, :], weight, smooth, scale, eps
    )
    return torch.mean(1.0 - 2.0 * gds)


def binary_focal_tversky_loss(pred, target, alpha=1.0, beta=1.0, gamma=1.0):
    p, t = _flatten_binary(pred, target)
    tp = torch.sum(p * t, dim=-1)
    d1 = torch.sum(p * (1 - t), dim=-1)
    d2 = torch.sum((1 - p) * t, dim=-1)
    nd = (tp + 1.0) / (tp + alpha * d1 + beta * d2 + 1.0)
    return torch.mean(1.0 - nd**gamma)


def combo_loss(
    pred, target, alpha=0.5, weight=1.0, gamma=1.0, scale=1.0, eps=eps
):
    """``alpha*focal + (1-alpha)*dice``; the dice receives ``eps`` as its
    smooth (the reference's positional call)."""
    bdl = binary_generalized_dice_loss(pred, target, weight, eps) * scale
    bce = binary_focal_loss(
        pred, target, gamma=gamma, alpha=weight, scale=scale
    )
    return alpha * bce + (1 - alpha) * bdl


def hybrid_focal_loss(
    pred, target, lam=0.5, focal_params=None, tversky_params=None
):
    focal_params = dict(focal_params or FOCAL_DEFAULT)
    tversky_params = dict(tversky_params or TVERSKY_DEFAULT)
    a = focal_params.get("alpha")
    if a is None or isinstance(a, (int, float)):
        focal_params["alpha"] = 1.0
    bfl = binary_focal_loss(pred, target, **focal_params)
    bftl = binary_focal_tversky_loss(pred, target, **tversky_params)
    return lam * bfl + (1 - lam) * bftl


def unified_focal_loss(
    pred, target, weight=1.0, gamma=0.5, lam=0.5, threshold=0.5, scale=1.0
):
    bfl = binary_focal_loss(
        pred, target, gamma=weight, alpha=1 - gamma,
        threshold=threshold, scale=scale,
    )
    bftl = binary_focal_tversky_loss(
        pred, target, alpha=weight, beta=1 - weight, gamma=gamma
    )
    return lam * bfl + (1 - lam) * bftl


# -- categorical -------------------------------------------------------------


def cat_cross_entropy(
    pred, target, weight=1.0, scale=1.0, label_smoothing=0.0, eps=eps
):
    """CE on softmax probabilities; the target gains a constant ``+1/C``."""
    n_classes = pred.shape[-1]
    p, t = _mc_flat(pred, target)
    t = t * (1 - label_smoothing) + 1.0 / n_classes
    ce = -t * torch.log(p + eps)
    if weight is not None:
        w = _as_tensor(weight, p)
        if w.dim() == 1:
            w = w.reshape((1,) * (ce.dim() - 1) + (-1,))
        ce = ce * w
    b = pred.shape[0]
    return torch.mean(torch.mean(ce.reshape(b, -1), dim=-1) * scale)


def mc_focal_loss(
    pred, target, alpha=None, gamma=1.0, scale=1.0, label_smoothing=0.0,
    eps=eps,
):
    n_classes = pred.shape[-1]
    p, t = _mc_flat(pred, target)
    a = torch.ones((), dtype=p.dtype, device=p.device)
    if alpha is not None:
        a = _as_tensor(alpha, p)
    if a.dim() == 1:
        a = a[None, None]
    p_t = torch.where(t > 0.5, p, 1 - p)
    t_s = t * (1 - label_smoothing) + 1.0 / n_classes
    ce = -t_s * torch.log(p + eps)
    out = a * ((1 - p_t + eps) ** gamma) * ce
    b = pred.shape[0]
    return torch.mean(torch.mean(out.reshape(b, -1), dim=-1) * scale)


def mc_generalized_dice_loss(
    pred, target, weight=1.0, smooth=1.0, scale=1.0, eps=eps
):
    p, t = _mc_flat(pred, target)
    gds = generalised_dice_score(
        p.transpose(1, 2), t.transpose(1, 2), weight, smooth, scale, eps
    )
    return torch.mean(1.0 - 2.0 * gds)


def mc_focal_tversky_loss(pred, target, alpha=1.0, beta=1.0, gamma=1.0):
    """Per-class Tversky with the reference's double +1."""
    p, t = _mc_flat(pred, target)
    n = torch.sum(p * t, dim=1) + 1.0
    d1 = _as_tensor(alpha, p) * torch.sum(p * (1 - t), dim=1)
    d2 = _as_tensor(beta, p) * torch.sum((1 - p) * t, dim=1)
    d = n + d1 + d2 + 1.0
    return torch.mean(torch.mean(1.0 - (n / d) ** gamma, dim=-1))


def mc_combo_loss(pred, target, alpha=0.5, weight=1.0, scale=1.0, eps=eps):
    """The dice receives ``scale`` as its smooth (the reference's
    positional call)."""
    bdl = mc_generalized_dice_loss(pred, target, weight, scale)
    bce = cat_cross_entropy(pred, target, weight, scale)
    return alpha * bce + (1 - alpha) * bdl


def mc_hybrid_focal_loss(
    pred, target, lam=1.0, focal_params=None, tversky_params=None
):
    focal_params = dict(focal_params or FOCAL_DEFAULT)
    tversky_params = dict(tversky_params or TVERSKY_DEFAULT)
    a = focal_params.get("alpha")
    if a is None or isinstance(a, (int, float)):
        focal_params["alpha"] = 1.0
    fl = mc_focal_loss(pred, target, **focal_params)
    ftl = mc_focal_tversky_loss(pred, target, **tversky_params)
    return lam * fl + (1 - lam) * ftl


def mc_unified_focal_loss(
    pred, target, delta=0.6, gamma=0.5, lam=0.5, scale=1.0
):
    fl = mc_focal_loss(
        pred, target, alpha=delta, gamma=1 - gamma, scale=scale
    )
    ftl = mc_focal_tversky_loss(
        pred, target, alpha=delta, beta=1 - delta, gamma=gamma
    )
    return lam * fl + (1 - lam) * ftl


loss_factory: Dict[str, Dict[str, Callable]] = {
    "binary": {
        "cross_entropy": binary_cross_entropy,
        "focal": binary_focal_loss,
        "dice": binary_generalized_dice_loss,
        "tversky_focal": binary_focal_tversky_loss,
        "combo": combo_loss,
        "hybrid_focal": hybrid_focal_loss,
        "unified_focal": unified_focal_loss,
    },
    "categorical": {
        "cross_entropy": cat_cross_entropy,
        "focal": mc_focal_loss,
        "dice": mc_generalized_dice_loss,
        "tversky_focal": mc_focal_tversky_loss,
        "combo": mc_combo_loss,
        "hybrid_focal": mc_hybrid_focal_loss,
        "unified_focal": mc_unified_focal_loss,
    },
}


class CompoundLoss:
    """Mean of weighted named losses with per-loss kwargs. Returns
    ``(total, {name: value})``; the total is ``sum(w_i * l_i) / k``, the
    mean the reference trains on."""

    def __init__(
        self,
        losses: Dict[str, Dict],
        weights: Optional[Dict[str, float]] = None,
    ):
        self.losses = {}
        for name, spec in losses.items():
            if callable(spec):
                self.losses[name] = {"fn": spec, "params": {}}
            elif "fn" in spec:
                self.losses[name] = {
                    "fn": spec["fn"],
                    "params": dict(spec.get("params", {})),
                }
            else:
                raise ValueError(f"loss spec for {name!r} needs 'fn'")
        self.weights = dict(weights or {})

    def replace_item(self, name: str, key: str, value):
        self.losses[name]["params"][key] = value

    def __call__(self, pred, target):
        total = 0.0
        individual = {}
        for name, spec in self.losses.items():
            value = spec["fn"](pred, target, **spec["params"])
            individual[name] = value
            total = total + self.weights.get(name, 1.0) * value
        return total / max(len(self.losses), 1), individual
