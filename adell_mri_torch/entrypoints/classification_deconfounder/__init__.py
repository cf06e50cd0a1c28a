"""``python -m adell_mri_torch classification_deconfounder``."""
