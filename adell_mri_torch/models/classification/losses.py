"""
Classification losses.

Counterpart of ``binary_logistic_loss``, ``cross_entropy_loss``,
``ordinal_sigmoidal_loss``, ``ordinal_prediction_to_class`` and
``ordinal_to_class_probs`` in
``adell_mri_tpu/models/classification/losses.py``.
"""

from typing import Optional

import torch
import torch.nn.functional as F


def binary_logistic_loss(logits, labels, weight: Optional[float] = None):
    """Mean binary cross entropy on logits (``[B, 1]`` or ``[B]``) against
    labels in [0, 1] (soft after smoothing or mixup); ``weight`` scales
    the terms whose label is above 0.5."""
    if logits.dim() > labels.dim():
        logits = logits[..., 0]
    labels = labels.to(logits.dtype)
    per = F.binary_cross_entropy_with_logits(logits, labels,
                                             reduction="none")
    if weight is not None:
        per = per * torch.where(labels > 0.5, weight, 1.0)
    return per.mean()


def cross_entropy_loss(logits, labels, weight=None,
                       label_smoothing: float = 0.0):
    """Mean cross entropy of ``logits`` [B, C] against class indices [B]
    or soft targets [B, C] (after mixup or smoothing); ``weight`` [C]
    weighs each term by its target's expected class weight."""
    n_classes = logits.shape[-1]
    if labels.dim() == logits.dim() and labels.shape[-1] == n_classes:
        oh = labels.float()
    else:
        oh = F.one_hot(labels.long(), n_classes).float()
    if label_smoothing > 0:
        oh = oh * (1 - label_smoothing) + label_smoothing / n_classes
    per = -(oh * torch.log_softmax(logits, dim=-1)).sum(-1)
    if weight is not None:
        w = torch.as_tensor(weight, dtype=oh.dtype, device=oh.device)
        per = per * (oh * w).sum(-1)
    return per.mean()


def ordinal_sigmoidal_loss(logits, labels, n_classes: int, weight=None):
    """Binary cross entropy of the cumulative-threshold logits [B, n-1]
    against the target ``k``'s thresholds (the first ``k`` positive),
    summed over the thresholds and averaged over the batch; ``weight``
    [n] weighs each sample by its class."""
    k = labels.long()
    thresholds = torch.arange(n_classes - 1, device=logits.device)
    target = (thresholds[None, :] < k[:, None]).to(logits.dtype)
    per = F.binary_cross_entropy_with_logits(logits, target,
                                             reduction="none")
    if weight is not None:
        w = torch.as_tensor(weight, dtype=per.dtype, device=per.device)
        per = per * w[k][:, None]
    return per.sum(-1).mean()


def ordinal_prediction_to_class(logits):
    """The predicted class: the number of thresholds whose sigmoid is
    above 0.5."""
    return (torch.sigmoid(logits) > 0.5).sum(-1)


def ordinal_to_class_probs(logits):
    """Cumulative-threshold logits [..., n-1] (``P(y > k)``) -> class
    probabilities [..., n]: ``P(y = k) = P(y > k-1) - P(y > k)`` with
    ``P(y > -1) = 1`` and ``P(y > n-1) = 0``, clamped at 1e-9 and
    renormalised (unordered thresholds can make a difference
    negative)."""
    cum = torch.sigmoid(logits)
    upper = torch.cat([torch.ones_like(cum[..., :1]), cum], -1)
    lower = torch.cat([cum, torch.zeros_like(cum[..., :1])], -1)
    p = (upper - lower).clamp_min(1e-9)
    return p / p.sum(-1, keepdim=True)
