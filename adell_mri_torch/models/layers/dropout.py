"""
Dropout that draws from an explicit generator.

The JAX package threads a PRNG key to every ``nn.Dropout``. Here each
``Dropout`` module holds a ``torch.Generator`` living on the device of the
tensors it masks; ``seed_dropout`` hands one generator to every dropout
layer of a model (and to every other layer that draws in training, such
as a batch ensemble's member choice), so a training run's draws follow
from its seed and not from the process-wide generator. Without one the
layer draws from the device's default generator.
"""

import torch
import torch.nn as nn


class Dropout(nn.Module):
    """Zeroes elements with probability ``p`` in training mode and scales
    the rest by ``1 / (1 - p)``; the identity in eval mode."""

    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout probability must be in [0, 1), got {p}")
        self.p = float(p)
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.rand(
            x.shape, device=x.device, generator=self.generator
        ) < keep
        return x * mask.to(x.dtype) / keep

    def extra_repr(self):
        return f"p={self.p}"


def seed_dropout(model: nn.Module, generator: torch.Generator) -> int:
    """Gives ``generator`` to every layer of ``model`` that draws from one
    (a ``generator`` attribute: ``Dropout``, ``BatchEnsembleConv``);
    returns how many there are."""
    layers = [m for m in model.modules() if hasattr(m, "generator")]
    for layer in layers:
        layer.generator = generator
    return len(layers)
