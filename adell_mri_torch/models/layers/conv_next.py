"""
Standalone ConvNeXt backbone and classifier.

Counterpart of ``ConvNeXtBackbone`` and ``ConvNeXt`` in
``adell_mri_tpu/models/layers/conv_next.py``, on channels-last tensors.
The backbone: a patchify stem (kernel ``max(s, 2)`` and stride ``s`` per
axis, SAME padding; with ``downsample="maxpool"`` kernel 4, VALID), flax's
LayerNorm (``stem_norm``), then a stage of ConvNeXt blocks
(``stage{s}_block{b}``) per ``structure`` entry. Between stages
``downsample="conv"`` puts a LayerNorm (``down_norm_{s}``) and a
kernel == stride conv to the stage's width (``down_conv_{s}``, SAME);
``"maxpool"`` widens in each stage's first block and max-pools (VALID)
after every stage. The classifier: the backbone, a mean over the spatial
axes, a LayerNorm (``head_norm``) and a Dense layer (``head``). Every
LayerNorm takes eps 1e-6, flax's default. The stem and the strided convs
are ``F.conv3d``, as XLA computes them in the JAX package; no conv here is
K1's class.
"""

from typing import Optional, Sequence, Tuple, Union

import torch.nn as nn

from adell_mri_torch.models.layers.adn import LayerNorm
from adell_mri_torch.models.layers.blocks import _tuple, max_pool
from adell_mri_torch.models.layers.res_blocks import ConvNeXtBlock
from adell_mri_torch.ops.conv import Conv3d, Pointwise


class ConvNeXtBackbone(nn.Module):
    def __init__(
        self,
        in_channels: int,
        structure: Sequence[Tuple[int, int, int, int]],
        first_layer_stride: Union[int, Sequence[int]] = 4,
        maxpool_structure: Optional[Sequence] = None,
        v2: bool = False,
        downsample: str = "conv",
    ):
        super().__init__()
        if downsample not in ("conv", "maxpool"):
            raise ValueError(f"downsample {downsample!r}: 'conv' or "
                             "'maxpool'")
        self.downsample = downsample
        f0 = structure[0][0]
        stride = _tuple(first_layer_stride, 3)
        if downsample == "maxpool":
            self.stem_conv = Conv3d(in_channels, f0, (4, 4, 4), stride,
                                    padding="VALID")
        else:
            self.stem_conv = Conv3d(in_channels, f0,
                                    tuple(max(s, 2) for s in stride), stride)
        self.stem_norm = LayerNorm(f0, 1e-6)
        pools = list(maxpool_structure or [2] * len(structure))
        if len(pools) != len(structure):
            # zip would drop trailing stages (see res_net.py)
            raise ValueError(
                f"maxpool_structure has {len(pools)} entries for "
                f"{len(structure)} backbone stages"
            )
        self.pools = [_tuple(p, 3) for p in pools]
        self.stages = []
        prev = f0
        for s, (ch, inter, k, n_blocks) in enumerate(structure):
            if downsample == "conv" and s > 0:
                self.add_module(f"down_norm_{s}", LayerNorm(prev, 1e-6))
                self.add_module(f"down_conv_{s}", Conv3d(
                    prev, ch, self.pools[s], self.pools[s]))
                prev = ch
            names = []
            for b in range(n_blocks):
                name = f"stage{s}_block{b}"
                self.add_module(name, ConvNeXtBlock(prev, ch, k, inter,
                                                    v2=v2))
                names.append(name)
                prev = ch
            self.stages.append(names)
        self.output_features = structure[-1][0]

    def forward(self, x):
        x = self.stem_norm(self.stem_conv(x))
        for s, names in enumerate(self.stages):
            if self.downsample == "conv" and s > 0:
                x = getattr(self, f"down_conv_{s}")(
                    getattr(self, f"down_norm_{s}")(x))
            for name in names:
                x = getattr(self, name)(x)
            if self.downsample == "maxpool":
                x = max_pool(x, self.pools[s])
        return x


class ConvNeXt(nn.Module):
    """``feature_extraction`` builds no ``head`` (the network a
    ``HybridClassifier`` wraps: the JAX one calls it for its features
    alone, so flax never creates the head); ``forward`` then returns the
    normalised pooled features."""

    def __init__(
        self,
        in_channels: int = 1,
        structure: Sequence[Tuple[int, int, int, int]] = (
            (64, 64, 7, 2), (128, 128, 7, 2)),
        n_classes: int = 2,
        first_layer_stride: Union[int, Sequence[int]] = 4,
        maxpool_structure: Optional[Sequence] = None,
        v2: bool = False,
        downsample: str = "conv",
        feature_extraction: bool = False,
    ):
        super().__init__()
        self.backbone = ConvNeXtBackbone(
            in_channels, [tuple(s) for s in structure], first_layer_stride,
            maxpool_structure, v2, downsample)
        self.n_features = self.backbone.output_features
        self.head_norm = LayerNorm(self.n_features, 1e-6)
        self.head = (None if feature_extraction else Pointwise(
            self.n_features, n_classes if n_classes > 2 else 1))

    def forward(self, x, return_features: bool = False):
        h = self.backbone(x)
        h = self.head_norm(h.mean(dim=tuple(range(1, h.dim() - 1))))
        if return_features or self.head is None:
            return h
        return self.head(h)
