"""Self-supervised models of the port: the two-view wrapper, I-JEPA,
their losses and the block masking."""

from adell_mri_torch.models.ssl import losses
from adell_mri_torch.models.ssl.masking import block_masking
from adell_mri_torch.models.ssl.nets import IJEPA, NonContrastiveWrapper

__all__ = ["losses", "block_masking", "IJEPA", "NonContrastiveWrapper"]
