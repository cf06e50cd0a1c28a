"""
Transformer segmentation: UNETR and SWIN-UNet.

Counterpart of ``UNETR``, ``SWINUNet``, ``_DecoderStage`` and
``tokens_to_volume`` in ``adell_mri_tpu/models/segmentation/unetr.py``:
UNETR, a ViT encoder whose intermediate token maps become U-Net skips
through ladders of transposed convs, and SWIN-UNet, a hierarchical SWIN
encoder whose stage outputs are the skips; both with a conv decoder.
Submodule names keep the JAX tree paths (``LinearEmbedding_0``,
``TransformerBlockStack_0/block_{i}``, ``SWINTransformerBlockStack_0``,
``Conv_0``, ``proj_{i}_{u}``, ``bn_proj``, ``dec_{i}/ConvTranspose_0``,
``dec_{i}/Conv_{0,1}``, ``Conv_1``, the heads of ``heads.py``) so
``interop/from_flax.py`` maps a JAX checkpoint key for key. UNETR's
positional embedding fixes the token count, so it is built for one
``image_size``; SWIN-UNet takes any size. 3D only; ``skip_conditioning``
and ``feature_conditioning`` raise ``NotImplementedError``; ``UNETRRef``
is not ported yet.
"""

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn

from adell_mri_torch.models.layers.adn import get_adn_fn
from adell_mri_torch.models.layers.blocks import _tuple, apply_adn
from adell_mri_torch.models.layers.multi_resolution import resize_like
from adell_mri_torch.models.layers.vit import (
    LinearEmbedding,
    SWINTransformerBlockStack,
    TransformerBlockStack,
)
from adell_mri_torch.models.segmentation.heads import add_heads, with_heads
from adell_mri_torch.ops.conv import Conv3d, ConvTranspose3d, Pointwise


def tokens_to_volume(tokens, grid, skip_tokens: int = 0):
    """[B, N(+extra), E] -> [B, *grid, E]."""
    t = tokens[:, skip_tokens:]
    return t.reshape((tokens.shape[0],) + tuple(grid) + (tokens.shape[-1],))


class _DecoderStage(nn.Module):
    """[Transposed conv 2x ->] resize to the skip's size if it differs ->
    concatenate the skip -> two 3x3x3 convs, each with its ADN.
    ``upsample=False`` merges a skip that sits at the input's own scale."""

    def __init__(self, in_channels, skip_channels, out_channels, adn_fn,
                 upsample: bool = True):
        super().__init__()
        self.ConvTranspose_0 = (
            ConvTranspose3d(in_channels, out_channels, _tuple(2, 3))
            if upsample else None
        )
        merged = (out_channels if upsample else in_channels) + skip_channels
        self.Conv_0 = Conv3d(merged, out_channels, _tuple(3, 3))
        self.adn_0 = adn_fn(out_channels)
        self.Conv_1 = Conv3d(out_channels, out_channels, _tuple(3, 3))
        self.adn_1 = adn_fn(out_channels)

    def forward(self, x, skip):
        if self.ConvTranspose_0 is not None:
            x = self.ConvTranspose_0(x)
        if x.shape[1:-1] != skip.shape[1:-1]:
            x = resize_like(x, skip.shape[1:-1])
        x = torch.cat([x, skip], dim=-1)
        x = apply_adn(self.adn_0, self.Conv_0(x))
        return apply_adn(self.adn_1, self.Conv_1(x))


_UNPORTED = {
    "skip_conditioning": None,
    "feature_conditioning": None,
    # the ADN has every norm, but no other is held against the JAX
    # UNETR and SWIN-UNet yet
    "norm_type": "instance",
}


def _reject_unported(net, **given):
    for key, want in _UNPORTED.items():
        if given[key] != want:
            raise NotImplementedError(
                f"{net} {key}={given[key]!r} is not ported yet (see "
                "ROADMAP.md)"
            )


class UNETR(nn.Module):
    """Takes and returns channels-last ``[B, *image_size, C]``. The output
    is the sigmoid (n_classes == 2, one channel) or softmax of the logits,
    or the logits themselves with ``return_logits=True``; with the heads'
    outputs when a head is on, unless ``heads=False`` (``heads.py``)."""

    def __init__(
        self,
        image_size: Sequence[int],
        in_channels: int = 1,
        spatial_dimensions: int = 3,
        n_classes: int = 2,
        patch_size: Sequence[int] = (8, 8, 8),
        embed_dim: int = 192,
        n_blocks: int = 8,
        n_heads: int = 6,
        feature_size: int = 16,
        norm_type: str = "instance",
        activation_fn: str = "swish",
        dropout_param: float = 0.0,
        return_at: Optional[Sequence[int]] = None,
        skip_conditioning: Optional[int] = None,
        feature_conditioning: Optional[int] = None,
        feature_conditioning_params: Optional[dict] = None,
        bottleneck_classification: bool = False,
        deep_supervision: bool = False,
    ):
        super().__init__()
        _reject_unported("UNETR", skip_conditioning=skip_conditioning,
                         feature_conditioning=feature_conditioning,
                         norm_type=norm_type)
        spatial = tuple(int(s) for s in image_size)
        if spatial_dimensions != 3 or len(spatial) != 3:
            raise NotImplementedError(
                "UNETR is ported for 3D inputs (spatial_dimensions=3 and a "
                f"3D image_size), got {spatial_dimensions} and {spatial}"
            )
        self.n_classes = n_classes
        self.spatial = spatial
        p = tuple(int(v) for v in patch_size)[:3]
        self.grid = tuple(s // pi for s, pi in zip(spatial, p))
        adn = get_adn_fn(norm_type, activation_fn, dropout_param)
        self.return_at = list(
            return_at if return_at is not None
            else [n_blocks // 4 - 1, n_blocks // 2 - 1, 3 * n_blocks // 4 - 1]
        )
        self.LinearEmbedding_0 = LinearEmbedding(
            in_channels, spatial, p, embed_dim=embed_dim,
            embed_method="convolutional", dropout=dropout_param,
        )
        self.TransformerBlockStack_0 = TransformerBlockStack(
            embed_dim, n_blocks, n_heads, dropout=dropout_param
        )
        f = feature_size
        self.Conv_0 = Conv3d(in_channels, f, _tuple(3, 3))
        self.adn_z0 = adn(f)

        # skip i lives at spatial / 2^(i+1): as many 2x transposed convs as
        # the smallest axis ratio asks for (at most log2 of the largest
        # patch side), then a resize where an anisotropic patch made some
        # axis overshoot
        n_inter = sum(1 for i in range(n_blocks) if i in self.return_at)
        n_up = max(1, int(round(math.log2(max(p)))))
        skip_shapes, skip_channels = [spatial], [f]
        self.ladders = []
        for i in range(n_inter):
            ch = f * 2 ** (i + 1)
            target = tuple(max(1, s // 2 ** (i + 1)) for s in spatial)
            ups, scale = 0, list(self.grid)
            while ups < n_up and any(s < t for s, t in zip(scale, target)):
                scale = [min(s * 2, t) for s, t in zip(scale, target)]
                ups += 1
            for u in range(ups):
                self.add_module(f"proj_{i}_{u}", ConvTranspose3d(
                    embed_dim if u == 0 else ch, ch, _tuple(2, 3)
                ))
                self.add_module(f"adn_proj_{i}_{u}", adn(ch))
            self.ladders.append((ups, target))
            skip_shapes.append(target)
            # without a transposed conv the skip keeps the token width
            skip_channels.append(ch if ups else embed_dim)

        curr_ch = f * 2 ** (n_inter + 1)
        self.bn_proj = Pointwise(embed_dim, curr_ch)
        self.adn_bn = adn(curr_ch)
        curr_shape = self.grid
        decoder_channels = []
        for i in range(n_inter, -1, -1):
            out_ch = max(f * 2 ** i, f)
            upsample = skip_shapes[i] != curr_shape
            self.add_module(f"dec_{i}", _DecoderStage(
                curr_ch, skip_channels[i], out_ch, adn, upsample=upsample
            ))
            curr_ch, curr_shape = out_ch, skip_shapes[i]
            decoder_channels.append(out_ch)
        self.n_skips = n_inter + 1
        n_out = n_classes if n_classes > 2 else 1
        self.Conv_1 = Pointwise(curr_ch, n_out)
        add_heads(self, adn, n_out, embed_dim, decoder_channels,
                  bottleneck_classification, deep_supervision)

    def forward(self, x, return_logits: bool = False,
                heads: bool = True):
        if tuple(x.shape[1:-1]) != self.spatial:
            raise ValueError(
                f"this UNETR was built for inputs of {self.spatial}, got "
                f"{tuple(x.shape[1:-1])} (the positional embedding fixes "
                "the token count)"
            )
        tokens = self.LinearEmbedding_0(x)
        tokens, inter = self.TransformerBlockStack_0(
            tokens, return_at=self.return_at
        )
        skips = [apply_adn(self.adn_z0, self.Conv_0(x))]
        for i, (t, (ups, target)) in enumerate(zip(inter, self.ladders)):
            vol = tokens_to_volume(t, self.grid)
            for u in range(ups):
                vol = getattr(self, f"proj_{i}_{u}")(vol)
                vol = apply_adn(getattr(self, f"adn_proj_{i}_{u}"), vol)
            if tuple(vol.shape[1:-1]) != target:
                vol = resize_like(vol, target)
            skips.append(vol)
        bottleneck = tokens_to_volume(tokens, self.grid)
        curr = apply_adn(self.adn_bn, self.bn_proj(bottleneck))
        deep_outputs = []
        for i in range(self.n_skips - 1, -1, -1):
            curr = getattr(self, f"dec_{i}")(curr, skips[i])
            deep_outputs.append(curr)
        return with_heads(
            self, _final(self, curr, self.spatial, return_logits),
            bottleneck, deep_outputs, heads,
        )


def _final(model, curr, spatial, return_logits):
    """``model.Conv_1`` on ``curr`` resized to ``spatial``, activated
    unless ``return_logits``."""
    if tuple(curr.shape[1:-1]) != tuple(spatial):
        curr = resize_like(curr, tuple(spatial))
    y = model.Conv_1(curr)
    if return_logits:
        return y
    return torch.softmax(y, -1) if model.n_classes > 2 else torch.sigmoid(y)


class SWINUNet(nn.Module):
    """SWIN encoder + conv decoder (``sample_configs/unet-swin.yaml``):
    the stack's stage outputs are the skips under a full-resolution stem
    skip (``Conv_0``, 3x3x3 to ``embed_dim``, with its ADN), and each
    ``dec_{i}`` upsamples by a transposed conv, resizes to its skip where
    the sizes differ, and applies two 3x3x3 convs. Takes channels-last
    ``[B, *S, C]`` of any size (no positional embedding), 3D only; the
    output is as UNETR's."""

    def __init__(
        self,
        in_channels: int = 1,
        spatial_dimensions: int = 3,
        n_classes: int = 2,
        embed_dim: int = 24,
        depths: Sequence[int] = (2, 2, 2),
        n_heads: Sequence[int] = (3, 6, 12),
        window_size: Sequence[int] = (4, 4, 4),
        patch_size: Sequence[int] = (2, 2, 2),
        norm_type: str = "instance",
        activation_fn: str = "swish",
        dropout_param: float = 0.0,
        skip_conditioning: Optional[int] = None,
        feature_conditioning: Optional[int] = None,
        feature_conditioning_params: Optional[dict] = None,
        bottleneck_classification: bool = False,
        deep_supervision: bool = False,
    ):
        super().__init__()
        _reject_unported("SWINUNet", skip_conditioning=skip_conditioning,
                         feature_conditioning=feature_conditioning,
                         norm_type=norm_type)
        if spatial_dimensions != 3:
            raise NotImplementedError(
                f"SWINUNet is ported for 3D inputs, got spatial_dimensions="
                f"{spatial_dimensions}"
            )
        self.n_classes = n_classes
        adn = get_adn_fn(norm_type, activation_fn, dropout_param)
        self.SWINTransformerBlockStack_0 = SWINTransformerBlockStack(
            in_channels, embed_dim=embed_dim, depths=depths, n_heads=n_heads,
            window_size=window_size, patch_size=patch_size,
            dropout=dropout_param,
        )
        widths = self.SWINTransformerBlockStack_0.widths
        f = embed_dim
        self.Conv_0 = Conv3d(in_channels, f, _tuple(3, 3))
        self.adn_z0 = adn(f)
        skip_channels = [f] + widths[:-1]
        curr_ch, decoder_channels = widths[-1], []
        for i in range(len(skip_channels) - 1, -1, -1):
            out_ch = max(skip_channels[i], f)
            self.add_module(f"dec_{i}", _DecoderStage(
                curr_ch, skip_channels[i], out_ch, adn
            ))
            curr_ch = out_ch
            decoder_channels.append(out_ch)
        self.n_skips = len(skip_channels)
        n_out = n_classes if n_classes > 2 else 1
        self.Conv_1 = Pointwise(curr_ch, n_out)
        add_heads(self, adn, n_out, widths[-1], decoder_channels,
                  bottleneck_classification, deep_supervision)

    def forward(self, x, return_logits: bool = False,
                heads: bool = True):
        bottleneck, feats = self.SWINTransformerBlockStack_0(x)
        skips = [apply_adn(self.adn_z0, self.Conv_0(x))] + feats[:-1]
        curr, deep_outputs = bottleneck, []
        for i in range(self.n_skips - 1, -1, -1):
            curr = getattr(self, f"dec_{i}")(curr, skips[i])
            deep_outputs.append(curr)
        return with_heads(
            self, _final(self, curr, x.shape[1:-1], return_logits),
            bottleneck, deep_outputs, heads,
        )
