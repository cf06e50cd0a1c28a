"""
Batch-ensemble convolution (rank-1 weight ensembles).

Counterpart of ``BatchEnsembleConv`` in
``adell_mri_tpu/models/layers/batch_ensemble.py`` with the 1x1 conv the
ResNet backbone gives it: one conv shared by ``n_ensemble`` members,
member ``i`` scaling the input channels by ``r[i] + 1`` and the output
channels by ``s[i] + 1``, then an ADN. In
training each sample takes a member drawn from the module's ``generator``
(``seed_dropout`` hands one over; without one the device's default
generator draws); in eval the output is the mean over the members, or
member ``idx`` alone.
"""

from typing import Optional

import torch
import torch.nn as nn

from adell_mri_torch.models.layers.blocks import apply_adn
from adell_mri_torch.ops.conv import Pointwise


class BatchEnsembleConv(nn.Module):
    def __init__(self, in_channels: int, n_ensemble: int, out_channels: int,
                 adn_fn=None):
        super().__init__()
        self.n_ensemble = n_ensemble
        # flax's normal(0.1); the forward adds the 1
        self.r = nn.Parameter(0.1 * torch.randn(n_ensemble, in_channels))
        self.s = nn.Parameter(0.1 * torch.randn(n_ensemble, out_channels))
        self.Conv_0 = Pointwise(in_channels, out_channels)
        self.ActDropNorm_0 = adn_fn(out_channels) if adn_fn else None
        self.generator = None

    def draw_members(self, batch: int, device) -> torch.Tensor:
        """One member index a sample, ``[batch]``."""
        return torch.randint(0, self.n_ensemble, (batch,), device=device,
                             generator=self.generator)

    def _member(self, x, r, s):
        bcast = (-1,) + (1,) * (x.dim() - 2)
        return self.Conv_0(x * r.reshape(bcast + (r.shape[-1],))) * s.reshape(
            bcast + (s.shape[-1],))

    def forward(self, x, idx: Optional[int] = None):
        r, s = self.r + 1.0, self.s + 1.0
        if idx is not None:
            y = self._member(x, r[idx:idx + 1], s[idx:idx + 1])
        elif self.training:
            members = self.draw_members(x.shape[0], x.device)
            y = self._member(x, r[members], s[members])
        else:
            y = sum(self._member(x, r[i:i + 1], s[i:i + 1])
                    for i in range(self.n_ensemble)) / self.n_ensemble
        return apply_adn(self.ActDropNorm_0, y)
