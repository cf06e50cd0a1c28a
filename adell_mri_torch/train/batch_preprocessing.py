"""
Batch-level preprocessing of the classification step: label smoothing,
mixup and partial mixup.

Counterpart of ``adell_mri_tpu/train/batch_preprocessing.py``. The draws
(mixup's Beta(alpha, alpha) weight, the partner permutation and partial
mixup's per-sample selection) come from a numpy generator seeded by the
caller, on the host: one scalar and two vectors of the batch's length a
step. ``mixup`` and ``partial_mixup`` take them as arguments, so a test
can hand them the JAX package's draws.
"""

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def label_smoothing(y, smoothing: float):
    """y in [0, 1] -> y * (1 - 2 s) + s (the binary convention)."""
    return y * (1.0 - 2.0 * smoothing) + smoothing


def mixup(x, y, lam, perm):
    """``lam * x + (1 - lam) * x[perm]``, and the same of the labels in
    f32; ``lam`` an f32 scalar, ``perm`` [B]."""
    lam = np.float32(lam)
    rest = np.float32(1.0) - lam
    y = y.float()
    return (float(lam) * x + float(rest) * x[perm],
            float(lam) * y + float(rest) * y[perm])


def partial_mixup(x, y, lam, perm, selected):
    """Mixup of the samples where ``selected`` [B] (bool) is set; the
    others keep their input and their f32 label."""
    x_mix, y_mix = mixup(x, y, lam, perm)
    sel_x = selected.reshape((-1,) + (1,) * (x.dim() - 1))
    sel_y = selected.reshape((-1,) + (1,) * (y.dim() - 1))
    return (torch.where(sel_x, x_mix, x),
            torch.where(sel_y, y_mix, y.float()))


class BatchPreprocessing:
    """``(x, y) -> (x, y)`` of the train step. Multiclass labels
    (``n_classes > 2``) become one-hot first, so mixup and smoothing give
    soft [B, C] targets (``cross_entropy_loss`` takes them); binary ones
    stay [B]. Mixup (partial with ``partial_mixup_fraction``) comes before
    smoothing."""

    def __init__(
        self,
        label_smoothing_param: Optional[float] = None,
        mixup_alpha: Optional[float] = None,
        partial_mixup_fraction: Optional[float] = None,
        seed: int = 42,
        n_classes: int = 2,
    ):
        self.label_smoothing = label_smoothing_param
        self.mixup_alpha = mixup_alpha
        self.partial_mixup_fraction = partial_mixup_fraction
        self.n_classes = n_classes
        self.rng = np.random.default_rng(seed)

    def __call__(self, x, y):
        multiclass = self.n_classes > 2
        if multiclass and y.dim() == 1:
            y = F.one_hot(y.long(), self.n_classes).float()
        if self.mixup_alpha is not None:
            b = x.shape[0]
            lam = self.rng.beta(self.mixup_alpha, self.mixup_alpha)
            perm = torch.from_numpy(self.rng.permutation(b)).to(x.device)
            if self.partial_mixup_fraction is not None:
                selected = torch.from_numpy(
                    self.rng.random(b) < self.partial_mixup_fraction
                ).to(x.device)
                x, y = partial_mixup(x, y, lam, perm, selected)
            else:
                x, y = mixup(x, y, lam, perm)
        if self.label_smoothing is not None:
            s = self.label_smoothing
            if multiclass:
                y = y.float() * (1.0 - s) + s / self.n_classes
            else:
                y = label_smoothing(y.float(), s)
        return x, y
