"""
Classification networks.

Counterpart of ``VGG``, ``CatNet``, ``OrdNet``, ``SegCatNet``,
``UNetEncoderClassifier``, ``ViTClassifier``, ``FactorizedViTClassifier``,
``TabularClassifier`` and ``HybridClassifier`` in
``adell_mri_tpu/models/classification/nets.py``.

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
- ``OrdNet``: the ResNet backbone (relu ADNs by default, no batch
  ensembles, the default pools of 2), a global max pool, Dense, relu and
  a bias-free Dense to one score; ``n_classes - 1`` cumulative logits
  ``score + threshold_bias * threshold_bias_scale``, the biases
  initialised to ``n-1, ..., 1`` and the scale to ``1 / (n-1)``
  (``return_only_pre_bias``: the score alone).
- ``UNetEncoderClassifier``: a U-Net built ``encoder_only`` (``unet``:
  only ``enc_{i}`` and ``enc_ds_{i}``, as flax creates no decoder when the
  JAX module returns at the bottleneck), a global max pool of the
  bottleneck, then ``MLP_0`` with the head's own 1-d ADN.
- ``ViTClassifier``: ``ViT_0`` (built for one image size: the learnt
  positional embedding fixes the token count), pooled by ``SeqPool_0``
  (``use_seq_pool``), else the class token, else the token mean, then
  ``MLP_0``: one Dense layer of ``embed_dim`` with a 1-d layer-norm, exact
  GELU ADN, then the output layer. ``FactorizedViTClassifier``: the same
  head on the class token of ``FactorizedViT_0``.
- ``TabularClassifier``: tabular features standardised by a stored mean
  and standard deviation (floored at 1e-6), then one Dense layer.
- ``HybridClassifier``: a headless image network's pooled features beside
  the standardised tabular features, then Dense, relu, Dense.

``VGG``, ``CatNet`` and ``OrdNet`` take ``spatial_dimensions`` as the JAX
modules do, where it changes nothing but the ADNs' layer-norm epsilon
(1D only): a JAX module's convs take the rank of its input, so the
classification CLI's volumes make a ``spatial_dimensions: 2`` network a
3D one in both packages. The port builds its weights before any input,
so it takes that rank as ``ndim`` (3, or 2 for the MIL slice encoder's
slices); a CatNet whose ``maxpool_structure`` lists another number of
axes fails where it is built, as the JAX one fails at its first call.

The output is one logit (binary) or ``n_classes``; activations live in
the losses. Inputs and feature maps are channels-last. With
``feature_extraction`` a network builds no head and returns its pooled
features (``n_features`` wide), as the JAX one does when a
``HybridClassifier`` calls it with ``return_features``: flax then never
creates the head, so the tree has none. The JAX ``OrdNet``,
``UNetEncoderClassifier`` and the two ViT classifiers take no
``return_features``, so a JAX ``HybridClassifier`` over them stops at
its first call; the port's return the features their head takes (the
pooled backbone, bottleneck or tokens).

CatNet's ``gp_head`` (``gaussian_process`` in a config) puts a
``GaussianProcessLayer`` named ``gp`` after the hidden layers in place of
the output Dense layer; ``forward(..., return_phi=True)`` returns its
random features beside the logits. ``GenericEnsemble`` fuses the pooled
features of member networks (``networks_{i}``, each built with
``feature_extraction``) by concatenation or mean into a ``(64,)`` relu
head; ``AveragingEnsemble`` averages the members' logits.
"""

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from adell_mri_torch.models.layers.adn import get_adn_fn
from adell_mri_torch.models.layers.gaussian_process import (
    GaussianProcessLayer,
)
from adell_mri_torch.models.layers.blocks import (
    MLP,
    GlobalPooling,
    VGGConvolution,
    add_mlp,
    run_mlp,
)
from adell_mri_torch.models.layers.res_net import (
    ProjectionHead,
    ResNet,
    ResNetBackbone,
)
from adell_mri_torch.models.layers.vit import FactorizedViT, SeqPool, ViT
from adell_mri_torch.ops.conv import Pointwise, lecun_normal_


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
        ndim: int = 3,
    ):
        super().__init__()
        self.n_classes = n_classes
        self.ResNetBackbone_0 = ResNetBackbone(
            in_channels,
            [tuple(s) for s in resnet_structure],
            maxpool_structure=maxpool_structure,
            adn_fn=get_adn_fn(norm_type, act_fn, dropout_param),
            res_type=res_type,
            batch_ensemble=batch_ensemble,
            ndim=ndim,
        )
        self.pool = GlobalPooling()
        d = self.n_features = self.ResNetBackbone_0.output_features
        hidden = (list(classification_structure)
                  if classification_structure is not None else [d] * 3)
        # the head's layers on CatNet itself, as in the JAX tree; the GP
        # head takes the place of the output Dense layer
        self.gp = None
        self.n_hidden = None if feature_extraction else add_mlp(
            self, d, hidden, None if gp_head else out_features(n_classes),
            get_adn_fn("batch", "gelu", 0.1))
        if gp_head and not feature_extraction:
            self.gp = GaussianProcessLayer(hidden[-1] if hidden else d,
                                           out_features(n_classes))

    def forward(self, x, return_features: bool = False,
                return_phi: bool = False, return_feature_map: bool = False):
        """Logits; with ``return_features`` the pooled features; with
        ``return_feature_map`` the backbone's feature map ``[B, *g, F]``
        before the pooling (VICRegL's local features); with ``return_phi``
        (a GP head) ``(logits, phi)``, phi the head's random features (what
        the JAX module sows as ``intermediates``)."""
        fmap = self.ResNetBackbone_0(x)
        if return_feature_map:
            return fmap
        feats = self.pool(fmap)
        if return_features or self.n_hidden is None:
            return feats
        y = run_mlp(self, self.n_hidden, feats)
        if self.gp is None:
            if return_phi:
                raise ValueError("return_phi needs a Gaussian-process head")
            return y
        return self.gp(y, return_phi=return_phi)


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
        ndim: int = 3,
    ):
        super().__init__()
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            d = first_depth * 2 ** i
            self.add_module(f"VGGConvolution_{i}", VGGConvolution(
                in_channels, d, norm_fn=norm_type, ndim=ndim))
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


class OrdNet(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        spatial_dimensions: int = 3,
        n_classes: int = 3,
        resnet_structure: Sequence[Tuple[int, int, int, int]] = (
            (64, 128, 5, 2),
            (128, 256, 3, 5),
        ),
        maxpool_structure: Optional[Sequence] = None,
        norm_type: str = "batch",
        act_fn: str = "relu",
        dropout_param: float = 0.0,
        feature_extraction: bool = False,
        ndim: int = 3,
    ):
        super().__init__()
        self.ResNetBackbone_0 = ResNetBackbone(
            in_channels, [tuple(s) for s in resnet_structure],
            maxpool_structure=maxpool_structure,
            adn_fn=get_adn_fn(norm_type, act_fn, dropout_param),
            ndim=ndim,
        )
        self.pool = GlobalPooling()
        d = self.n_features = self.ResNetBackbone_0.output_features
        self.head = not feature_extraction
        if self.head:
            self.Dense_0 = Pointwise(d, d)
            self.Dense_1 = nn.Linear(d, 1, bias=False)
            lecun_normal_(self.Dense_1.weight, d)
            self.threshold_bias = nn.Parameter(torch.arange(
                n_classes - 1, 0, -1, dtype=torch.float32))
            self.threshold_bias_scale = nn.Parameter(
                torch.tensor(1.0 / (n_classes - 1)))

    def forward(self, x, return_only_pre_bias: bool = False,
                return_features: bool = False):
        feats = self.pool(self.ResNetBackbone_0(x))
        if return_features or not self.head:
            return feats
        score = self.Dense_1(F.relu(self.Dense_0(feats)))
        if return_only_pre_bias:
            return score
        bias = self.threshold_bias * self.threshold_bias_scale
        return score + bias.to(score.dtype)[None, :]


class UNetEncoderClassifier(nn.Module):
    """``unet``: a ``UNet`` built ``encoder_only`` (its ``depth[-1]``-wide
    bottleneck is pooled); ``head_adn_fn``: the head's 1-d ADN."""

    def __init__(self, unet: nn.Module, n_features: int, n_classes: int = 2,
                 head_structure: Sequence[int] = (256,), head_adn_fn=None,
                 feature_extraction: bool = False):
        super().__init__()
        self.unet = unet
        self.pool = GlobalPooling()
        self.n_features = n_features
        self.MLP_0 = None if feature_extraction else MLP(
            n_features, tuple(head_structure), out_features(n_classes),
            head_adn_fn or get_adn_fn("batch", "gelu", 0.0, spatial_dim=1))

    def forward(self, x, return_features: bool = False):
        feats = self.pool(self.unet(x))
        if return_features or self.MLP_0 is None:
            return feats
        return self.MLP_0(feats)


def _vit_head(embed_dim: int, n_classes: int) -> MLP:
    return MLP(embed_dim, (embed_dim,), out_features(n_classes),
               get_adn_fn("layer", "gelu", 0.0, spatial_dim=1))


class SegCatNet(nn.Module):
    """Classifies from a frozen U-Net's features (``unet``, its
    ``return_features`` forward; both feature maps pass through
    ``.detach()``, the JAX module's ``stop_gradient``, so no gradient
    reaches the U-Net): a ``ResNet`` over the final features
    (``final_layer_classifier``: stages (d, 2d, 3, 2), (2d, 2d, 3, 2),
    (4d, 4d, 3, 2) with d the final features' width, pools of 2, batch
    norm, swish and dropout 0.1 ADNs, prediction head [4d] * 3) and a
    ``ProjectionHead`` over the bottleneck (``bottleneck_classifier``,
    [db, 2db, 4db, 2db, db]), each followed by a bias-free Dense layer to
    the outputs (``final_layer_linear``, ``bottleneck_linear``), combined
    by a bias-free Dense layer (``weighted_average``). The heads' ADNs are
    1-d."""

    def __init__(self, unet: nn.Module, n_classes: int = 2):
        super().__init__()
        self.unet = unet
        d, db = unet.depth[0], unet.depth[-1]
        nc = out_features(n_classes)
        head_adn = get_adn_fn("batch", "swish", 0.1, spatial_dim=1)
        self.final_layer_classifier = ResNet(
            d, ((d, 2 * d, 3, 2), (2 * d, 2 * d, 3, 2), (4 * d, 4 * d, 3, 2)),
            maxpool_structure=(2, 2, 2),
            adn_fn=get_adn_fn("batch", "swish", 0.1), head_adn_fn=head_adn,
            res_type="resnet", prediction_head_structure=(4 * d,) * 3)
        self.final_layer_linear = _bias_free(4 * d, nc)
        self.bottleneck_classifier = ProjectionHead(
            db, (db, 2 * db, 4 * db, 2 * db, db), head_adn)
        self.bottleneck_linear = _bias_free(db, nc)
        self.weighted_average = _bias_free(2 * nc, nc)

    def forward(self, x):
        _, final_features, bottleneck = self.unet(x, return_features=True)
        class_fl = self.final_layer_linear(self.final_layer_classifier(
            final_features.detach(), ret="prediction"))
        class_bn = self.bottleneck_linear(
            self.bottleneck_classifier(bottleneck.detach()))
        return self.weighted_average(torch.cat([class_fl, class_bn], -1))


def _bias_free(in_features: int, out_features_: int) -> nn.Linear:
    """flax's ``Dense(use_bias=False)``: a lecun-normal kernel."""
    layer = nn.Linear(in_features, out_features_, bias=False)
    lecun_normal_(layer.weight, in_features)
    return layer


class ViTClassifier(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        image_size: Sequence[int] = (128, 128, 32),
        patch_size: Sequence[int] = (4, 4, 4),
        n_classes: int = 2,
        embed_dim: int = 256,
        n_blocks: int = 4,
        n_heads: int = 4,
        dropout_param: float = 0.0,
        use_class_token: bool = True,
        use_seq_pool: bool = False,
        moe_experts: int = 0,
        embed_method: str = "linear",
        mlp_ratio: float = 4.0,
        embed_norm: bool = False,
        mlp_structure: Optional[Sequence[int]] = None,
        feature_extraction: bool = False,
    ):
        super().__init__()
        self.ViT_0 = ViT(
            in_channels, image_size, patch_size, embed_dim=embed_dim,
            n_blocks=n_blocks, n_heads=n_heads, mlp_ratio=mlp_ratio,
            dropout=dropout_param, embed_method=embed_method,
            use_class_token=use_class_token, moe_experts=moe_experts,
            embed_norm=embed_norm, mlp_structure=mlp_structure,
        )
        self.use_class_token = use_class_token
        self.SeqPool_0 = SeqPool(embed_dim) if use_seq_pool else None
        self.n_features = embed_dim
        self.MLP_0 = (None if feature_extraction
                      else _vit_head(embed_dim, n_classes))

    def forward(self, x, return_features: bool = False):
        tokens = self.ViT_0(x)
        if self.SeqPool_0 is not None:
            feats = self.SeqPool_0(tokens)
        elif self.use_class_token:
            feats = tokens[:, 0]
        else:
            feats = tokens.mean(1)
        if return_features or self.MLP_0 is None:
            return feats
        return self.MLP_0(feats)


class FactorizedViTClassifier(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        image_size: Sequence[int] = (128, 128, 32),
        patch_size: Sequence[int] = (4, 4),
        n_classes: int = 2,
        embed_dim: int = 256,
        n_blocks: int = 4,
        n_heads: int = 4,
        dropout_param: float = 0.0,
        feature_extraction: bool = False,
    ):
        super().__init__()
        self.FactorizedViT_0 = FactorizedViT(
            in_channels, image_size, patch_size, embed_dim=embed_dim,
            n_blocks=n_blocks, n_heads=n_heads, dropout=dropout_param,
        )
        self.n_features = embed_dim
        self.MLP_0 = (None if feature_extraction
                      else _vit_head(embed_dim, n_classes))

    def forward(self, x, return_features: bool = False):
        feats = self.FactorizedViT_0(x)[:, 0]
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


class GenericEnsemble(nn.Module):
    """``networks``: member networks built with ``feature_extraction``
    (``n_features`` each), kept as ``networks_{i}`` as in the JAX tree;
    their pooled features fused by ``fusion`` "concat" or "mean", then
    Dense layers of ``head_structure`` with relu, then the output
    layer."""

    def __init__(self, networks: Sequence[nn.Module], n_classes: int = 2,
                 fusion: str = "concat",
                 head_structure: Sequence[int] = (64,)):
        super().__init__()
        if fusion not in ("concat", "mean"):
            raise ValueError(f"unknown fusion {fusion!r} (concat, mean)")
        self.n_networks = len(networks)
        self.fusion = fusion
        for i, net in enumerate(networks):
            self.add_module(f"networks_{i}", net)
        widths = [net.n_features for net in networks]
        width = sum(widths) if fusion == "concat" else widths[0]
        self.n_hidden = len(head_structure)
        for i, h in enumerate(list(head_structure)
                              + [out_features(n_classes)]):
            self.add_module(f"Dense_{i}", Pointwise(width, h))
            width = h

    def forward(self, x):
        feats = [getattr(self, f"networks_{i}")(x, return_features=True)
                 for i in range(self.n_networks)]
        f = (torch.cat(feats, -1) if self.fusion == "concat"
             else sum(feats) / len(feats))
        for i in range(self.n_hidden):
            f = F.relu(_dense(getattr(self, f"Dense_{i}"), f))
        return _dense(getattr(self, f"Dense_{self.n_hidden}"), f)


class AveragingEnsemble(nn.Module):
    """The mean of the member networks' (``networks_{i}``) outputs."""

    def __init__(self, networks: Sequence[nn.Module]):
        super().__init__()
        self.n_networks = len(networks)
        for i, net in enumerate(networks):
            self.add_module(f"networks_{i}", net)

    def forward(self, x):
        outs = [getattr(self, f"networks_{i}")(x)
                for i in range(self.n_networks)]
        return sum(outs) / len(outs)
