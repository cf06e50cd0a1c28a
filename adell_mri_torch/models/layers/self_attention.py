"""
Squeeze-and-excite gates and the attention-gated skip link.

Counterpart of ``ChannelSqueezeAndExcite``, ``SpatialSqueezeAndExcite``,
``ConcurrentSqueezeAndExcite`` and ``SelfAttentionBlock`` in
``adell_mri_tpu/models/layers/self_attention.py``, on channels-last
tensors. Submodules keep the flax tree's auto names (``Dense_{i}``,
``Conv_{i}``, ``ChannelSqueezeAndExcite_0``, ``SpatialSqueezeAndExcite_0``);
every 1x1 conv and Dense layer is a ``Pointwise`` product.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from adell_mri_torch.ops.conv import Pointwise


class ChannelSqueezeAndExcite(nn.Module):
    """Spatial mean -> Dense(C // reduction) -> ReLU -> Dense(C) ->
    sigmoid, a gate per channel."""

    def __init__(self, channels: int, reduction: int = 2):
        super().__init__()
        self.Dense_0 = Pointwise(channels, max(1, channels // reduction))
        self.Dense_1 = Pointwise(max(1, channels // reduction), channels)

    def forward(self, x):
        s = x.mean(dim=tuple(range(1, x.dim() - 1)))
        s = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(s))))
        return x * s.reshape((x.shape[0],) + (1,) * (x.dim() - 2)
                             + (x.shape[-1],))


class SpatialSqueezeAndExcite(nn.Module):
    """1x1 conv to one channel -> sigmoid, a gate per voxel."""

    def __init__(self, channels: int):
        super().__init__()
        self.Conv_0 = Pointwise(channels, 1)

    def forward(self, x):
        return x * torch.sigmoid(self.Conv_0(x))


class ConcurrentSqueezeAndExcite(nn.Module):
    """The elementwise max of the channel and the spatial gate (scSE)."""

    def __init__(self, channels: int, reduction: int = 2):
        super().__init__()
        self.ChannelSqueezeAndExcite_0 = ChannelSqueezeAndExcite(
            channels, reduction)
        self.SpatialSqueezeAndExcite_0 = SpatialSqueezeAndExcite(channels)

    def forward(self, x):
        return torch.maximum(self.ChannelSqueezeAndExcite_0(x),
                             self.SpatialSqueezeAndExcite_0(x))


class SelfAttentionBlock(nn.Module):
    """Attention gate of a U-Net skip: the gating signal and the skip each
    go 1x1 to ``inter_channels``, are summed and ReLU'd, go 1x1 to one
    channel and through a sigmoid, which multiplies the skip."""

    def __init__(self, gate_channels: int, skip_channels: int,
                 inter_channels: int):
        super().__init__()
        self.Conv_0 = Pointwise(gate_channels, inter_channels)
        self.Conv_1 = Pointwise(skip_channels, inter_channels)
        self.Conv_2 = Pointwise(inter_channels, 1)

    def forward(self, gate, skip):
        psi = F.relu(self.Conv_0(gate) + self.Conv_1(skip))
        return skip * torch.sigmoid(self.Conv_2(psi))
