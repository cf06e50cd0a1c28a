"""Classification models of the port: VGG, CatNet (every ``res_type``,
the Gaussian-process head), the standalone ConvNeXt, the tabular and
hybrid classifiers, the two ensembles, the MIL models over 2D slice
encoders, SegCatNet and the deconfounded classifier."""

from adell_mri_torch.models.classification.deconfounded import (
    DeconfoundedNet,
    correlation_penalty,
)
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
    SegCatNet,
    TabularClassifier,
)
from adell_mri_torch.models.layers.conv_next import ConvNeXt

__all__ = ["VGG", "AveragingEnsemble", "CatNet", "ConvNeXt",
           "DeconfoundedNet", "GenericEnsemble", "HybridClassifier",
           "MILAttention", "MultipleInstanceClassifier", "SegCatNet",
           "TabularClassifier", "TransformableTransformer",
           "correlation_penalty"]
