"""
Classification networks.

Counterpart of ``CatNet`` in ``adell_mri_tpu/models/classification/
nets.py`` (the ``classification-cat-*.yaml`` surface: ``resnet_structure``,
``maxpool_structure``, ``res_type``, ``batch_ensemble``), for
``res_type`` "resnet": the ResNet backbone, a global max pool, then
``[d] * 3`` Dense layers (``d`` the backbone's output width, or
``classification_structure``), each followed by a 1-d batch-norm, exact
GELU, dropout 0.1 ADN, then a Dense layer with one logit (binary) or
``n_classes``. Inputs and feature maps are channels-last; the output is
the logits, activations live in the losses. The Gaussian-process head and
feature-extraction mode are not ported yet.
"""

from typing import Optional, Sequence, Tuple

import torch.nn as nn

from adell_mri_torch.models.layers.adn import get_adn_fn
from adell_mri_torch.models.layers.blocks import (
    GlobalPooling,
    add_mlp,
    run_mlp,
)
from adell_mri_torch.models.layers.res_net import ResNetBackbone


def out_features(n_classes: int) -> int:
    return 1 if n_classes == 2 else n_classes


class CatNet(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        spatial_dimensions: int = 3,
        n_classes: int = 2,
        resnet_structure: Sequence[Tuple[int, int, int, int]] = (
            (64, 128, 5, 2),
            (128, 256, 3, 5),
        ),
        maxpool_structure: Optional[Sequence] = None,
        res_type: str = "resnet",
        batch_ensemble: int = 0,
        norm_type: str = "batch",
        act_fn: str = "swish",
        dropout_param: float = 0.0,
        classification_structure: Optional[Sequence[int]] = None,
        feature_extraction: bool = False,
        gp_head: bool = False,
    ):
        super().__init__()
        if spatial_dimensions != 3:
            raise NotImplementedError("2D classifiers are not ported yet")
        if gp_head:
            raise NotImplementedError(
                "the Gaussian-process head (gaussian_process) is not ported "
                "yet"
            )
        if feature_extraction:
            raise NotImplementedError(
                "feature_extraction is not ported yet"
            )
        self.n_classes = n_classes
        self.ResNetBackbone_0 = ResNetBackbone(
            in_channels,
            [tuple(s) for s in resnet_structure],
            maxpool_structure=maxpool_structure,
            adn_fn=get_adn_fn(norm_type, act_fn, dropout_param),
            res_type=res_type,
            batch_ensemble=batch_ensemble,
        )
        self.pool = GlobalPooling()
        d = self.ResNetBackbone_0.output_features
        hidden = (list(classification_structure)
                  if classification_structure is not None else [d] * 3)
        # the head's layers on CatNet itself, as in the JAX tree
        self.n_hidden = add_mlp(self, d, hidden, out_features(n_classes),
                                get_adn_fn("batch", "gelu", 0.1))

    def forward(self, x, return_features: bool = False):
        feats = self.pool(self.ResNetBackbone_0(x))
        if return_features:
            return feats
        return run_mlp(self, self.n_hidden, feats)
