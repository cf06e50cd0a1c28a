"""
Config-driven U-Net.

Counterpart of ``adell_mri_tpu/models/segmentation/unet.py`` (``UNet``,
``_ConvUnit``, ``_final_layer``) for 3D inputs, with every ``conv_type``
of the JAX ``_ConvUnit`` but the ``_ref`` ones (``regular``, ``resnet``,
``sae``, ``depthwise``, ``convnext``, ``convnextv2``, ``asp``), every
``link_type`` (``identity``, ``conv``, ``residual``, ``attention``), both
``upscale_type``s (``transpose``, ``upsample`` with any ``interpolation``
``resize_like`` takes) and the decoder's resize where the upsampled and
skip sizes differ; every norm, prelu and uout ADNs (``adn.py``), with or
without bottleneck classification and deep supervision (``heads.py``).
Submodule names keep the JAX tree paths (``enc_{i}``, ``enc_ds_{i}``,
``link_{i}``, ``link_adn_{i}``, ``up_{i}``, ``dec_{i}``,
``Conv_0/Conv_1``, and inside a unit flax's auto names) so
``interop/from_flax.py`` maps a JAX checkpoint key for key. With
``encoder_only`` the U-Net is its encoder (``enc_{i}``, ``enc_ds_{i}``)
and returns the bottleneck: the tree the JAX module has when it returns
there (``return_bottleneck``, ``encoder_only``), since flax creates the
decoder's and the heads' parameters only when they run. With
``encoder_structure`` (a list of (channels, inter_channels, kernel_size,
n_blocks) stages: the SSL backbone's) the encoder is a ``ResNetBackbone``
under ``encoder_backbone`` with ``res_type`` blocks, the U-Net's ADN and
the pools ``strides[1:]``; its skips are the stem's output and each
stage's before its pool, the last of which is the bottleneck, so
``depth`` must be ``[stem_f, *stage_channels]`` and the decoder goes up
by ``strides[-2::-1]`` (``strides[0]`` the stem's pool of 2). 2D,
skip/feature conditioning, ``semi_supervised`` and the ``_ref`` conv
types raise ``NotImplementedError``. The links keep the
skip's width, so the JAX ``link_proj_{i}`` (needed only when
conditioning widens the skip) never arises.
"""

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from adell_mri_torch.models.layers.adn import get_adn_fn
from adell_mri_torch.models.layers.blocks import _tuple, apply_adn, max_pool
from adell_mri_torch.models.layers.multi_resolution import (
    AtrousSpatialPyramidPooling,
    resize_like,
)
from adell_mri_torch.models.layers.res_blocks import (
    ConvNeXtBlock,
    ResidualBlock,
)
from adell_mri_torch.models.layers.res_net import ResNetBackbone
from adell_mri_torch.models.layers.self_attention import (
    ConcurrentSqueezeAndExcite,
    SelfAttentionBlock,
)
from adell_mri_torch.models.segmentation.heads import add_heads, with_heads
from adell_mri_torch.ops.conv import (
    Conv3d,
    ConvTranspose3d,
    DwConv,
    Pointwise,
)

CONV_TYPES = ("regular", "resnet", "sae", "depthwise", "convnext",
              "convnextv2", "asp")
LINK_TYPES = ("identity", "conv", "residual", "attention")
# a resnet encoder decodes with regular units, asp with sae units
_DECODER_CONV = {"resnet": "regular", "asp": "sae"}


class _ConvUnit(nn.Module):
    """One unit of ``conv_type``, then the unit's ADN:

    - regular/sae: Conv(in->in, k, stride) -> ADN -> Conv(in->out, k, 1)
      (sae: then the concurrent squeeze-excite);
    - depthwise: depthwise Conv(in, k, stride) -> ADN -> 1x1 Conv(in->out);
    - resnet: ``ResidualBlock`` (bottleneck of inter = in when in > 32,
      else the plain two-conv one), then on strided units a SAME max pool;
    - convnext(v2): ``ConvNeXtBlock``, or on strided units one SAME
      strided Conv(in->out, k);
    - asp: ``AtrousSpatialPyramidPooling`` (rates 1, 2), then on strided
      units a SAME strided Conv(out->out, k).

    The strided regular and depthwise convs pad symmetrically by k//2
    (torch's padding; XLA's SAME would put the odd pad on the high side),
    the strided convnext and asp convs by XLA's SAME."""

    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 conv_type, adn_fn):
        super().__init__()
        k = _tuple(kernel_size, 3)
        s = _tuple(stride, 3)
        strided = any(si != 1 for si in s)
        pad = tuple((ki // 2, ki // 2) for ki in k) if strided else "SAME"
        self.conv_type, self.pool = conv_type, s if strided else None
        if conv_type in ("regular", "sae"):
            self.Conv_0 = Conv3d(in_channels, in_channels, k, strides=s,
                                 padding=pad)
            self.ActDropNorm_0 = adn_fn(in_channels)
            self.Conv_1 = Conv3d(in_channels, out_channels, k)
            if conv_type == "sae":
                self.ConcurrentSqueezeAndExcite_0 = (
                    ConcurrentSqueezeAndExcite(out_channels))
            out_adn = "ActDropNorm_1"
        elif conv_type == "depthwise":
            self.Conv_dw = DwConv(in_channels, k, strides=s, padding=pad)
            self.ActDropNorm_0 = adn_fn(in_channels)
            self.Conv_pw = Pointwise(in_channels, out_channels)
            out_adn = "ActDropNorm_1"
        elif conv_type == "resnet":
            self.ResidualBlock_0 = ResidualBlock(
                in_channels, k[0], out_channels, adn_fn,
                inter_channels=in_channels if in_channels > 32 else None)
            out_adn = "ActDropNorm_0"
        elif conv_type in ("convnext", "convnextv2"):
            if strided:
                self.Conv_0 = Conv3d(in_channels, out_channels, k,
                                     strides=s)
            else:
                self.ConvNeXtBlock_0 = ConvNeXtBlock(
                    in_channels, out_channels, v2=conv_type.endswith("v2"))
            out_adn = "ActDropNorm_0"
        elif conv_type == "asp":
            self.AtrousSpatialPyramidPooling_0 = AtrousSpatialPyramidPooling(
                in_channels, out_channels, rates=(1, 2), adn_fn=adn_fn)
            if strided:
                self.Conv_0 = Conv3d(out_channels, out_channels, k,
                                     strides=s)
            out_adn = "ActDropNorm_0"
        else:
            raise NotImplementedError(f"conv_type {conv_type!r}")
        self.out_adn = out_adn
        self.add_module(out_adn, adn_fn(out_channels))

    def forward(self, x):
        ct = self.conv_type
        if ct in ("regular", "sae"):
            x = apply_adn(self.ActDropNorm_0, self.Conv_0(x))
            x = self.Conv_1(x)
            if ct == "sae":
                x = self.ConcurrentSqueezeAndExcite_0(x)
        elif ct == "depthwise":
            x = apply_adn(self.ActDropNorm_0, self.Conv_dw(x))
            x = self.Conv_pw(x)
        elif ct == "resnet":
            x = self.ResidualBlock_0(x)
            if self.pool is not None:
                x = max_pool(x, self.pool, padding="SAME")
        elif ct in ("convnext", "convnextv2"):
            x = (self.Conv_0(x) if self.pool is not None
                 else self.ConvNeXtBlock_0(x))
        else:
            x = self.AtrousSpatialPyramidPooling_0(x)
            if self.pool is not None:
                x = self.Conv_0(x)
        return apply_adn(getattr(self, self.out_adn), x)


# options the port does not serve yet, each with the value it serves
_UNPORTED = {
    "spatial_dimensions": 3,
    "skip_conditioning": None,
    "feature_conditioning": None,
    "semi_supervised": False,
}


class UNet(nn.Module):
    """Takes and returns channels-last ``[B, D, H, W, C]``. The output is
    the sigmoid (n_classes == 2, one channel) or softmax of the logits, or
    the logits themselves with ``return_logits=True``; with the heads'
    outputs when a head is on, unless ``heads=False`` (``heads.py``); with
    ``encoder_only``, the bottleneck ``[B, *S', depth[-1]]``; with
    ``return_features`` the output, the final features and the
    bottleneck. The defaults are the JAX module's but for
    ``spatial_dimensions`` (3: 2D is not ported)."""

    def __init__(
        self,
        spatial_dimensions: int = 3,
        conv_type: str = "regular",
        link_type: str = "identity",
        upscale_type: str = "upsample",
        interpolation: str = "linear",
        norm_type: str = "batch",
        dropout_type: str = "dropout",
        dropout_param: float = 0.1,
        activation_fn: str = "prelu",
        in_channels: int = 1,
        n_classes: int = 2,
        depth: Sequence[int] = (16, 32, 64),
        kernel_sizes: Sequence[int] = (3, 3, 3),
        strides: Sequence[int] = (2, 2, 2),
        bottleneck_classification: bool = False,
        skip_conditioning: Optional[int] = None,
        feature_conditioning: Optional[int] = None,
        feature_conditioning_params: Optional[Dict[str, Any]] = None,
        deep_supervision: bool = False,
        encoder_only: bool = False,
        semi_supervised: bool = False,
        encoder_structure=None,
        res_type: str = "resnet",
    ):
        super().__init__()
        given = {
            "spatial_dimensions": spatial_dimensions,
            "skip_conditioning": skip_conditioning,
            "feature_conditioning": feature_conditioning,
            "semi_supervised": semi_supervised,
        }
        for key, want in _UNPORTED.items():
            if given[key] != want:
                raise NotImplementedError(
                    f"UNet {key}={given[key]!r} is not ported yet (the port "
                    f"serves {key}={want!r}; see ROADMAP.md)"
                )
        if conv_type not in CONV_TYPES:
            raise NotImplementedError(
                f"UNet conv_type={conv_type!r} is not ported yet (the port "
                f"has {', '.join(CONV_TYPES)}; see ROADMAP.md)")
        if link_type not in LINK_TYPES:
            raise NotImplementedError(f"UNet link_type={link_type!r}")
        if upscale_type not in ("transpose", "upsample"):
            raise NotImplementedError(f"UNet upscale_type={upscale_type!r}")
        self.n_classes = n_classes
        self.link_type, self.upscale_type = link_type, upscale_type
        self.interpolation = interpolation
        depth, ks, st = list(depth), list(kernel_sizes), list(strides)
        self.n_levels, self.depth = len(depth), depth
        adn_fn = get_adn_fn(
            norm_type, activation_fn, dropout_param, dropout_type
        )

        self.resnet_encoder = encoder_structure is not None
        if self.resnet_encoder:
            structure = [tuple(s) for s in encoder_structure]
            want = [structure[0][0]] + [s[0] for s in structure]
            if depth != want:
                raise ValueError(
                    "with encoder_structure, depth must be [stem_f, "
                    f"*stage_channels] = {want}, got {depth}")
            self.encoder_backbone = ResNetBackbone(
                in_channels, structure,
                maxpool_structure=[_tuple(s, 3) for s in st[1:]],
                adn_fn=adn_fn, res_type=res_type)
        in_ch = in_channels
        for i, d in enumerate([] if self.resnet_encoder else depth):
            self.add_module(f"enc_{i}", _ConvUnit(in_ch, d, ks[i], 1,
                                                  conv_type, adn_fn))
            if i < len(depth) - 1:
                self.add_module(f"enc_ds_{i}", _ConvUnit(
                    d, d, ks[i], st[i], conv_type, adn_fn))
            in_ch = d
        self.encoder_only = encoder_only
        if encoder_only:
            return
        curr_ch = depth[-1]
        self.up_strides = []
        dec_ct = _DECODER_CONV.get(conv_type, conv_type)
        for i, (d, k, s) in enumerate(
            zip(depth[-2::-1], ks[-2::-1], st[-2::-1])
        ):
            s = _tuple(s, 3)
            self.up_strides.append(s)
            if link_type == "conv":
                self.add_module(f"link_{i}", Conv3d(d, d, _tuple(3, 3)))
                self.add_module(f"link_adn_{i}", adn_fn(d))
            elif link_type == "residual":
                self.add_module(f"link_{i}", ResidualBlock(d, 3, d, adn_fn))
            elif link_type == "attention":
                self.add_module(f"link_{i}",
                                SelfAttentionBlock(curr_ch, d, 16))
            if upscale_type == "upsample" or s == (1, 1, 1):
                # a kernel == stride == 1 transposed conv is a 1x1 conv too
                self.add_module(f"up_{i}", Pointwise(curr_ch, d))
            else:
                self.add_module(f"up_{i}", ConvTranspose3d(curr_ch, d, s))
            self.add_module(f"dec_{i}", _ConvUnit(2 * d, d, k, 1, dec_ct,
                                                  adn_fn))
            curr_ch = d
        d0 = depth[0]
        self.Conv_0 = Conv3d(d0, d0, _tuple(3, 3))
        self.final_adn = adn_fn(d0)
        n_out = n_classes if n_classes > 2 else 1
        self.Conv_1 = Pointwise(d0, n_out)
        add_heads(self, adn_fn, n_out, depth[-1], depth[-2::-1],
                  bottleneck_classification, deep_supervision)

    def _link(self, i, curr, skip):
        if self.link_type == "identity":
            return skip
        link = getattr(self, f"link_{i}")
        if self.link_type == "conv":
            return apply_adn(getattr(self, f"link_adn_{i}"), link(skip))
        if self.link_type == "attention":
            return link(resize_like(curr, skip.shape[1:-1]), skip)
        return link(skip)

    def forward(self, x, return_logits: bool = False,
                heads: bool = True, return_features: bool = False):
        """With ``return_features``, ``(output, final_features,
        bottleneck)``: the output (no heads' outputs beside it), the last
        decoder unit's features before the final conv and the encoder's
        last level, as the JAX module returns them."""
        if self.resnet_encoder:
            _, encoding_out = self.encoder_backbone(
                x, return_intermediate=True, return_stem=True)
            curr = encoding_out[-1]
        else:
            encoding_out = []
            curr = x
            for i in range(self.n_levels):
                curr = getattr(self, f"enc_{i}")(curr)
                encoding_out.append(curr)
                if i < self.n_levels - 1:
                    curr = getattr(self, f"enc_ds_{i}")(curr)
        if self.encoder_only:
            return curr
        bottleneck, deep_outputs = curr, []
        for i, s in enumerate(self.up_strides):
            encoded = self._link(i, curr, encoding_out[-i - 2])
            curr = getattr(self, f"up_{i}")(curr)
            if self.upscale_type == "upsample":
                curr = resize_like(
                    curr, [n * f for n, f in zip(curr.shape[1:-1], s)],
                    method=self.interpolation)
            if curr.shape[1:-1] != encoded.shape[1:-1]:
                curr = resize_like(curr, encoded.shape[1:-1])
            curr = getattr(self, f"dec_{i}")(torch.cat([curr, encoded], -1))
            deep_outputs.append(curr)
        y = apply_adn(self.final_adn, self.Conv_0(curr))
        y = self.Conv_1(y)
        if not return_logits:
            y = (torch.softmax(y, -1) if self.n_classes > 2
                 else torch.sigmoid(y))
        if return_features:
            return y, curr, bottleneck
        return with_heads(self, y, bottleneck, deep_outputs, heads)
