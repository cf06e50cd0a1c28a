"""Classification models of the port: VGG, CatNet (every ``res_type``),
the standalone ConvNeXt, and the tabular and hybrid classifiers."""

from adell_mri_torch.models.classification.nets import (
    VGG,
    CatNet,
    HybridClassifier,
    TabularClassifier,
)
from adell_mri_torch.models.layers.conv_next import ConvNeXt

__all__ = ["VGG", "CatNet", "ConvNeXt", "HybridClassifier",
           "TabularClassifier"]
