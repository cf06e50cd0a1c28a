"""
Residual blocks.

Counterpart of ``ResidualBlock`` in
``adell_mri_tpu/models/layers/res_blocks.py``. Without ``inter_channels``
(the UNet's residual link): two kxk convs with an ADN between them, the
skip added, an optional 1x1 projection, then the trailing ADN. With it
(the ResNet backbone's bottleneck): 1x1 to ``inter_channels``, ADN, kxk,
ADN, 1x1 back to the input width, the skip added, the 1x1 projection when
the width changes, then the trailing ADN.
"""

import torch.nn as nn

from adell_mri_torch.models.layers.blocks import _tuple, apply_adn
from adell_mri_torch.ops.conv import Conv3d, Pointwise


class ResidualBlock(nn.Module):
    def __init__(
        self,
        in_channels: int,
        kernel_size: int = 3,
        out_channels: int = None,
        adn_fn=None,
        inter_channels: int = None,
    ):
        super().__init__()
        out_channels = out_channels or in_channels
        k = _tuple(kernel_size, 3)

        def adn(features):
            return adn_fn(features) if adn_fn else None

        # names pin the JAX tree paths: Conv_0, Conv_1 (and Conv_2 with a
        # bottleneck), the projection next, ActDropNorm_{i} in call order
        if inter_channels is None:
            self.Conv_0 = Conv3d(in_channels, in_channels, k)
            self.ActDropNorm_0 = adn(in_channels)
            self.Conv_1 = Conv3d(in_channels, in_channels, k)
            proj_name, out_adn = "Conv_2", "ActDropNorm_1"
        else:
            self.Conv_0 = Pointwise(in_channels, inter_channels)
            self.ActDropNorm_0 = adn(inter_channels)
            self.Conv_1 = Conv3d(inter_channels, inter_channels, k)
            self.ActDropNorm_1 = adn(inter_channels)
            self.Conv_2 = Pointwise(inter_channels, in_channels)
            proj_name, out_adn = "Conv_3", "ActDropNorm_2"
        self.bottleneck = inter_channels is not None
        self.proj_name, self.out_adn = proj_name, out_adn
        self.add_module(proj_name, (
            Pointwise(in_channels, out_channels)
            if in_channels != out_channels else None))
        self.add_module(out_adn, adn(out_channels))

    def forward(self, x):
        y = apply_adn(self.ActDropNorm_0, self.Conv_0(x))
        y = self.Conv_1(y)
        if self.bottleneck:
            y = self.Conv_2(apply_adn(self.ActDropNorm_1, y))
        out = y + x
        proj = getattr(self, self.proj_name)
        if proj is not None:
            out = proj(out)
        return apply_adn(getattr(self, self.out_adn), out)
