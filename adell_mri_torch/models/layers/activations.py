"""
Activation registry, the subset the ported models use.

Counterpart of ``adell_mri_tpu/models/layers/activations.py``. Names the
JAX registry has and this one lacks raise ``NotImplementedError``.
"""

from typing import Callable, Dict

import torch
import torch.nn.functional as F


activation_factory: Dict[str, Callable] = {
    # the exact (erf) GELU, torch's default and the JAX registry's
    "gelu": F.gelu,
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "swish": F.silu,
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def get_activation(name: str) -> Callable:
    try:
        return activation_factory[name]
    except KeyError:
        raise NotImplementedError(
            f"activation {name!r} is not ported yet; available: "
            f"{sorted(activation_factory)}"
        ) from None
