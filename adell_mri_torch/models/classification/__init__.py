"""Classification models of the port: CatNet with a ResNet backbone."""

from adell_mri_torch.models.classification.nets import CatNet

__all__ = ["CatNet"]
