"""
Classification networks.

Counterpart of ``VGG``, ``CatNet``, ``TabularClassifier`` and
``HybridClassifier`` in ``adell_mri_tpu/models/classification/nets.py``.

- ``VGG`` (``vggnet-net.yaml``): ``n_blocks`` ``VGGConvolution`` blocks of
  width ``first_depth * 2**i`` (``VGGConvolution_{i}``), a global max
  pool, then ``MLP_0``: Dense layers of ``classification_structure``
  (512, 512, 512), each followed by a 1-d batch-norm, exact GELU, dropout
  0.1 ADN, then the output Dense layer.
- ``CatNet`` (the ``classification-cat-*.yaml`` surface:
  ``resnet_structure``, ``maxpool_structure``, ``res_type``,
  ``batch_ensemble``): the ResNet backbone with blocks of any
  ``res_type``, a global max pool, then ``[d] * 3`` Dense layers (``d``
  the backbone's output width, or ``classification_structure``) with the
  same 1-d ADN, then the output Dense layer.
- ``TabularClassifier``: tabular features standardised by a stored mean
  and standard deviation (floored at 1e-6), then one Dense layer.
- ``HybridClassifier``: a headless image network's pooled features beside
  the standardised tabular features, then Dense, relu, Dense.

The output is one logit (binary) or ``n_classes``; activations live in
the losses. Inputs and feature maps are channels-last. With
``feature_extraction`` a network builds no head and returns its pooled
features (``n_features`` wide), as the JAX one does when a
``HybridClassifier`` calls it with ``return_features``: flax then never
creates the head, so the tree has none. The Gaussian-process head is not
ported yet.
"""

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from adell_mri_torch.models.layers.adn import get_adn_fn
from adell_mri_torch.models.layers.blocks import (
    MLP,
    GlobalPooling,
    VGGConvolution,
    add_mlp,
    run_mlp,
)
from adell_mri_torch.models.layers.res_net import ResNetBackbone
from adell_mri_torch.ops.conv import Pointwise


def out_features(n_classes: int) -> int:
    return 1 if n_classes == 2 else n_classes


class CatNet(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        spatial_dimensions: int = 3,
        n_classes: int = 2,
        resnet_structure: Sequence[Tuple[int, int, int, int]] = (
            (64, 128, 5, 2),
            (128, 256, 3, 5),
        ),
        maxpool_structure: Optional[Sequence] = None,
        res_type: str = "resnet",
        batch_ensemble: int = 0,
        norm_type: str = "batch",
        act_fn: str = "swish",
        dropout_param: float = 0.0,
        classification_structure: Optional[Sequence[int]] = None,
        feature_extraction: bool = False,
        gp_head: bool = False,
    ):
        super().__init__()
        if spatial_dimensions != 3:
            raise NotImplementedError("2D classifiers are not ported yet")
        if gp_head:
            raise NotImplementedError(
                "the Gaussian-process head (gaussian_process) is not ported "
                "yet"
            )
        self.n_classes = n_classes
        self.ResNetBackbone_0 = ResNetBackbone(
            in_channels,
            [tuple(s) for s in resnet_structure],
            maxpool_structure=maxpool_structure,
            adn_fn=get_adn_fn(norm_type, act_fn, dropout_param),
            res_type=res_type,
            batch_ensemble=batch_ensemble,
        )
        self.pool = GlobalPooling()
        d = self.n_features = self.ResNetBackbone_0.output_features
        hidden = (list(classification_structure)
                  if classification_structure is not None else [d] * 3)
        # the head's layers on CatNet itself, as in the JAX tree
        self.n_hidden = None if feature_extraction else add_mlp(
            self, d, hidden, out_features(n_classes),
            get_adn_fn("batch", "gelu", 0.1))

    def forward(self, x, return_features: bool = False):
        feats = self.pool(self.ResNetBackbone_0(x))
        if return_features or self.n_hidden is None:
            return feats
        return run_mlp(self, self.n_hidden, feats)


class VGG(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        spatial_dimensions: int = 3,
        n_classes: int = 2,
        first_depth: int = 16,
        n_blocks: int = 4,
        norm_type: str = "batch",
        classification_structure: Sequence[int] = (512, 512, 512),
        feature_extraction: bool = False,
    ):
        super().__init__()
        if spatial_dimensions != 3:
            raise NotImplementedError("2D classifiers are not ported yet")
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            d = first_depth * 2 ** i
            self.add_module(f"VGGConvolution_{i}", VGGConvolution(
                in_channels, d, norm_fn=norm_type))
            in_channels = 2 * d
        self.n_features = in_channels
        self.pool = GlobalPooling()
        self.MLP_0 = None if feature_extraction else MLP(
            in_channels, tuple(classification_structure),
            out_features(n_classes), get_adn_fn("batch", "gelu", 0.1))

    def forward(self, x, return_features: bool = False):
        for i in range(self.n_blocks):
            x = getattr(self, f"VGGConvolution_{i}")(x)
        feats = self.pool(x)
        if return_features or self.MLP_0 is None:
            return feats
        return self.MLP_0(feats)


class _Standardise(nn.Module):
    """``(x - mean) / max(std, 1e-6)`` with the stored statistics (f32
    buffers outside the ``state_dict``: the checkpoint's metadata keeps
    them), computed in f32 as the JAX modules promote the features
    against their f32 statistics; the identity without statistics."""

    def __init__(self, mean: Optional[Sequence[float]],
                 std: Optional[Sequence[float]]):
        super().__init__()
        self.active = mean is not None
        if self.active:
            self.register_buffer("mean", torch.tensor(
                list(mean), dtype=torch.float32), persistent=False)
            self.register_buffer("std", torch.tensor(
                list(std), dtype=torch.float32), persistent=False)

    def forward(self, x):
        if not self.active:
            return x
        return ((x.float() - self.mean.float())
                / self.std.float().clamp_min(1e-6))


def _dense(layer: Pointwise, x):
    """A Dense layer as flax applies it: input and parameters promoted to
    their common dtype (bf16 weights on f32 features compute in f32)."""
    dtype = torch.promote_types(x.dtype, layer.weight.dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class TabularClassifier(nn.Module):
    def __init__(self, n_features: int, n_classes: int = 2,
                 mean: Optional[Sequence[float]] = None,
                 std: Optional[Sequence[float]] = None):
        super().__init__()
        self.standardise = _Standardise(mean, std)
        self.Dense_0 = Pointwise(n_features, out_features(n_classes))

    def forward(self, x):
        return _dense(self.Dense_0, self.standardise(x))


class HybridClassifier(nn.Module):
    """``convolutional_module``: a network built with
    ``feature_extraction`` (its ``n_features`` pooled features); the
    tabular input is ``[B, n_tabular]``."""

    def __init__(self, convolutional_module: nn.Module, n_tabular: int,
                 n_classes: int = 2,
                 tab_mean: Optional[Sequence[float]] = None,
                 tab_std: Optional[Sequence[float]] = None):
        super().__init__()
        self.convolutional_module = convolutional_module
        self.standardise = _Standardise(tab_mean, tab_std)
        width = convolutional_module.n_features + n_tabular
        self.Dense_0 = Pointwise(width, width)
        self.Dense_1 = Pointwise(width, out_features(n_classes))

    def forward(self, x, x_tab):
        img = self.convolutional_module(x, return_features=True)
        x_tab = self.standardise(x_tab)
        dtype = torch.promote_types(img.dtype, x_tab.dtype)
        feats = torch.cat([img.to(dtype), x_tab.to(dtype)], -1)
        return _dense(self.Dense_1, F.relu(_dense(self.Dense_0, feats)))
