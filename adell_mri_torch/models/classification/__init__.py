"""Classification models of the port: VGG, CatNet (every ``res_type``,
the Gaussian-process head), the standalone ConvNeXt, the tabular and
hybrid classifiers, the two ensembles and the MIL models over 2D slice
encoders."""

from adell_mri_torch.models.classification.mil import (
    MILAttention,
    MultipleInstanceClassifier,
    TransformableTransformer,
)
from adell_mri_torch.models.classification.nets import (
    VGG,
    AveragingEnsemble,
    CatNet,
    GenericEnsemble,
    HybridClassifier,
    TabularClassifier,
)
from adell_mri_torch.models.layers.conv_next import ConvNeXt

__all__ = ["VGG", "AveragingEnsemble", "CatNet", "ConvNeXt",
           "GenericEnsemble", "HybridClassifier", "MILAttention",
           "MultipleInstanceClassifier", "TabularClassifier",
           "TransformableTransformer"]
