"""
Deconfounded classification.

Counterpart of ``adell_mri_tpu/models/classification/deconfounded.py``:
a backbone's pooled features are projected into a classification
subspace (``cls_proj``) and a confounder subspace (``conf_proj``);
surrogate heads predict each categorical confounder (``cat_conf_{i}``)
and the continuous ones (``cont_conf``) from the confounder subspace, the
classifier (``classifier``) reads the classification subspace, and
``correlation_penalty`` between the two subspaces keeps them apart. The
layer names are the JAX tree's, the backbone's under ``backbone``.
"""

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from adell_mri_torch.models.classification.nets import out_features
from adell_mri_torch.models.layers.blocks import GlobalPooling
from adell_mri_torch.ops.conv import Pointwise


def correlation_penalty(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared cross-correlation between feature blocks ``[B, Fa]``
    and ``[B, Fb]``: each column centred over the batch and scaled to unit
    norm (floored at 1e-6), then the mean of ``(a^T b)**2``."""
    a = a - a.mean(dim=0, keepdim=True)
    b = b - b.mean(dim=0, keepdim=True)
    a = a / torch.linalg.norm(a, dim=0, keepdim=True).clamp_min(1e-6)
    b = b / torch.linalg.norm(b, dim=0, keepdim=True).clamp_min(1e-6)
    return torch.matmul(a.transpose(0, 1), b).square().mean()


class DeconfoundedNet(nn.Module):
    """``backbone``: a network built with ``feature_extraction`` whose
    ``forward(x, return_features=True)`` gives its ``n_features`` pooled
    features; ``n_features_deconfounder`` sizes the confounder subspace
    (the classification subspace takes the rest, at least 16);
    ``n_cat_deconfounder`` the classes of each categorical confounder;
    ``n_cont_deconfounder`` the continuous ones. ``forward`` returns
    ``(logits, [categorical logits], continuous predictions or None,
    penalty)``, or the logits alone with ``return_all=False``."""

    def __init__(self, backbone: nn.Module, n_classes: int = 2,
                 n_features_deconfounder: int = 32,
                 n_cat_deconfounder: Sequence[int] = (),
                 n_cont_deconfounder: int = 0):
        super().__init__()
        self.backbone = backbone
        self.pool = GlobalPooling()
        width = backbone.n_features
        cls_width = max(width - n_features_deconfounder, 16)
        self.conf_proj = Pointwise(width, n_features_deconfounder)
        self.cls_proj = Pointwise(width, cls_width)
        self.classifier = Pointwise(cls_width, out_features(n_classes))
        self.n_cat = len(n_cat_deconfounder)
        for i, nc in enumerate(n_cat_deconfounder):
            self.add_module(f"cat_conf_{i}",
                            Pointwise(n_features_deconfounder, nc))
        self.cont_conf = (Pointwise(n_features_deconfounder,
                                    n_cont_deconfounder)
                          if n_cont_deconfounder > 0 else None)

    def forward(self, x, return_all: bool = True):
        feats = self.backbone(x, return_features=True)
        if feats.dim() > 2:
            feats = self.pool(feats)
        f_conf, f_cls = self.conf_proj(feats), self.cls_proj(feats)
        logits = self.classifier(F.relu(f_cls))
        if not return_all:
            return logits
        conf = F.relu(f_conf)
        cat_preds = [getattr(self, f"cat_conf_{i}")(conf)
                     for i in range(self.n_cat)]
        cont_preds = (self.cont_conf(conf) if self.cont_conf is not None
                      else None)
        return logits, cat_preds, cont_preds, correlation_penalty(f_cls,
                                                                  f_conf)
