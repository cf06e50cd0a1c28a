"""
Residual blocks.

Counterpart of ``ResidualBlock``, ``ResNeXtBlock``, ``ConvNeXtBlock`` and
``RES_BLOCK_REGISTRY`` in ``adell_mri_tpu/models/layers/res_blocks.py``.
``ResidualBlock`` without ``inter_channels``
(the UNet's residual link): two kxk convs with an ADN between them, the
skip added, an optional 1x1 projection, then the trailing ADN. With it
(the ResNet backbone's bottleneck): 1x1 to ``inter_channels``, ADN, kxk,
ADN, 1x1 back to the input width, the skip added, the 1x1 projection when
the width changes, then the trailing ADN. ``ConvNeXtBlock``: a depthwise
7^3 conv, flax's LayerNorm, the two Dense layers around a GELU (flax's,
the tanh approximation), GRN (v2) or LayerScale (v1), the skip added, and
a 1x1 conv + GELU where the width changes. ``ResNeXtBlock``: the
bottleneck with a grouped kxk conv (``min(n_splits, inter)`` groups, the
inner width rounded down to a multiple of them). ``ndim`` is the number of
spatial axes of the input (3, or 2 for the 2D networks), which the JAX
blocks read from their input.
"""

import torch.nn as nn
import torch.nn.functional as F

from adell_mri_torch.models.layers.adn import LayerNorm
from adell_mri_torch.models.layers.blocks import _tuple, apply_adn
from adell_mri_torch.models.layers.regularization import GRN, LayerScale
from adell_mri_torch.ops.conv import Conv3d, DwConv, Pointwise


class ResidualBlock(nn.Module):
    def __init__(
        self,
        in_channels: int,
        kernel_size: int = 3,
        out_channels: int = None,
        adn_fn=None,
        inter_channels: int = None,
        ndim: int = 3,
    ):
        super().__init__()
        out_channels = out_channels or in_channels
        k = _tuple(kernel_size, ndim)

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


class ConvNeXtBlock(nn.Module):
    """Module names are the JAX tree's: ``Conv_0`` (the depthwise conv),
    ``LayerNorm_0``, ``Dense_0``, ``Dense_1``, ``GRN_0`` or
    ``LayerScale_0``, ``Conv_1`` (the projection)."""

    def __init__(self, in_channels: int, out_channels: int = None,
                 kernel_size: int = 7, inter_channels: int = None,
                 v2: bool = False, layer_scale_init: float = 1e-6,
                 ndim: int = 3):
        super().__init__()
        out_channels = out_channels or in_channels
        inter = inter_channels or 4 * in_channels
        self.Conv_0 = DwConv(in_channels, _tuple(kernel_size, ndim))
        self.LayerNorm_0 = LayerNorm(in_channels, 1e-6)
        self.Dense_0 = Pointwise(in_channels, inter)
        self.Dense_1 = Pointwise(inter, in_channels)
        if v2:
            self.GRN_0 = GRN(inter)
        else:
            self.LayerScale_0 = LayerScale(in_channels, layer_scale_init)
        self.v2 = v2
        self.Conv_1 = (Pointwise(in_channels, out_channels)
                       if in_channels != out_channels else None)

    def forward(self, x):
        y = self.LayerNorm_0(self.Conv_0(x))
        y = F.gelu(self.Dense_0(y), approximate="tanh")
        if self.v2:
            y = self.GRN_0(y)
        y = self.Dense_1(y)
        if not self.v2:
            y = self.LayerScale_0(y)
        out = y + x
        if self.Conv_1 is not None:
            out = F.gelu(self.Conv_1(out), approximate="tanh")
        return out


class ResNeXtBlock(nn.Module):
    """Module names are the JAX tree's: ``Conv_0`` (1x1 to the inner
    width), ``ActDropNorm_0``, ``Conv_1`` (the grouped kxk conv, a grouped
    ``F.conv3d``), ``ActDropNorm_1``, ``Conv_2`` (1x1 back), ``Conv_3``
    (the projection, where the width changes), ``ActDropNorm_2``."""

    def __init__(
        self,
        in_channels: int,
        kernel_size: int = 3,
        out_channels: int = None,
        adn_fn=None,
        inter_channels: int = None,
        n_splits: int = 16,
        ndim: int = 3,
    ):
        super().__init__()
        out_channels = out_channels or in_channels
        inter = inter_channels or in_channels
        groups = min(n_splits, inter)
        inter = (inter // groups) * groups or groups

        def adn(features):
            return adn_fn(features) if adn_fn else None

        self.Conv_0 = Pointwise(in_channels, inter)
        self.ActDropNorm_0 = adn(inter)
        self.Conv_1 = Conv3d(inter, inter, _tuple(kernel_size, ndim),
                             groups=groups)
        self.ActDropNorm_1 = adn(inter)
        self.Conv_2 = Pointwise(inter, in_channels)
        self.Conv_3 = (Pointwise(in_channels, out_channels)
                       if in_channels != out_channels else None)
        self.ActDropNorm_2 = adn(out_channels)

    def forward(self, x):
        y = apply_adn(self.ActDropNorm_0, self.Conv_0(x))
        y = apply_adn(self.ActDropNorm_1, self.Conv_1(y))
        out = self.Conv_2(y) + x
        if self.Conv_3 is not None:
            out = self.Conv_3(out)
        return apply_adn(self.ActDropNorm_2, out)


def _convnext(v2: bool):
    def ctor(in_channels, kernel_size, out_channels, adn_fn=None,
             inter_channels=None, ndim=3):
        # the JAX block accepts adn_fn and ignores it
        return ConvNeXtBlock(in_channels, out_channels, kernel_size,
                             inter_channels, v2=v2, ndim=ndim)

    return ctor


#: res_type -> ``ctor(in_channels, kernel_size, out_channels, adn_fn,
#: inter_channels, ndim=...)``; the ResNet backbone names each block by
#: its class
RES_BLOCK_REGISTRY = {
    "resnet": ResidualBlock,
    "resnext": ResNeXtBlock,
    "convnext": _convnext(False),
    "convnextv2": _convnext(True),
}
