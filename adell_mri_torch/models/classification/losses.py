"""
Classification losses.

Counterpart of ``binary_logistic_loss`` and ``cross_entropy_loss`` in
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
