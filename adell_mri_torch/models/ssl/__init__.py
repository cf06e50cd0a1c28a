"""Self-supervised models of the port: the two-view wrapper (VICRegL's
local features too), I-JEPA, DINO, iBOT, the masked autoencoder, their
losses and the token masking."""

from adell_mri_torch.models.ssl import losses
from adell_mri_torch.models.ssl.masking import block_masking, random_masking
from adell_mri_torch.models.ssl.nets import (
    DINO,
    IBOT,
    IJEPA,
    DINOHead,
    NonContrastiveWrapper,
    ViTMaskedAutoEncoder,
)

__all__ = ["losses", "block_masking", "random_masking", "DINO", "DINOHead",
           "IBOT", "IJEPA", "NonContrastiveWrapper", "ViTMaskedAutoEncoder"]
