"""
Config-driven U-Net, the configurations the port serves so far.

Counterpart of ``adell_mri_tpu/models/segmentation/unet.py`` (``UNet``,
``_ConvUnit``, ``_final_layer``) for 3D inputs with ``conv_type="regular"``,
``link_type="residual"`` and ``upscale_type="transpose"``: the flagship
configuration, with or without bottleneck classification and deep
supervision (``heads.py``). Submodule names keep the JAX tree paths
(``enc_{i}``, ``enc_ds_{i}``, ``link_{i}``, ``up_{i}``, ``dec_{i}``,
``Conv_0/Conv_1``) so ``interop/from_flax.py`` maps a JAX checkpoint key
for key. Every other option raises ``NotImplementedError``.
"""

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from adell_mri_torch.models.layers.adn import get_adn_fn
from adell_mri_torch.models.layers.blocks import _tuple, apply_adn
from adell_mri_torch.models.layers.res_blocks import ResidualBlock
from adell_mri_torch.models.segmentation.heads import add_heads, with_heads
from adell_mri_torch.ops.conv import Conv3d, ConvTranspose3d, Pointwise


class _ConvUnit(nn.Module):
    """Regular unit: Conv(in->in, k, stride) -> ADN -> Conv(in->out, k, 1)
    -> ADN. A strided conv pads symmetrically by k//2 (torch's padding;
    XLA's SAME would put the odd pad on the high side)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride, adn_fn):
        super().__init__()
        k = _tuple(kernel_size, 3)
        s = _tuple(stride, 3)
        pad = (
            tuple((ki // 2, ki // 2) for ki in k)
            if any(si != 1 for si in s)
            else "SAME"
        )
        self.Conv_0 = Conv3d(
            in_channels, in_channels, k, strides=s, padding=pad
        )
        self.adn_0 = adn_fn(in_channels)
        self.Conv_1 = Conv3d(in_channels, out_channels, k)
        self.adn_out = adn_fn(out_channels)

    def forward(self, x):
        x = apply_adn(self.adn_0, self.Conv_0(x))
        return apply_adn(self.adn_out, self.Conv_1(x))


_SUPPORTED = {
    "spatial_dimensions": 3,
    "conv_type": "regular",
    "link_type": "residual",
    "upscale_type": "transpose",
    "skip_conditioning": None,
    "feature_conditioning": None,
    "encoder_only": False,
    "semi_supervised": False,
    "encoder_structure": None,
    # the segmentation steps carry no batch-norm statistics
    "norm_type": "instance",
}


class UNet(nn.Module):
    """Takes and returns channels-last ``[B, D, H, W, C]``. The output is
    the sigmoid (n_classes == 2, one channel) or softmax of the logits, or
    the logits themselves with ``return_logits=True``; with the heads'
    outputs when a head is on, unless ``heads=False`` (``heads.py``)."""

    def __init__(
        self,
        spatial_dimensions: int = 3,
        conv_type: str = "regular",
        link_type: str = "residual",
        upscale_type: str = "transpose",
        interpolation: str = "linear",
        norm_type: str = "instance",
        dropout_type: str = "dropout",
        dropout_param: float = 0.0,
        activation_fn: str = "swish",
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
            "conv_type": conv_type,
            "link_type": link_type,
            "upscale_type": upscale_type,
            "skip_conditioning": skip_conditioning,
            "feature_conditioning": feature_conditioning,
            "encoder_only": encoder_only,
            "semi_supervised": semi_supervised,
            "encoder_structure": encoder_structure,
            "norm_type": norm_type,
        }
        for key, want in _SUPPORTED.items():
            if given[key] != want:
                raise NotImplementedError(
                    f"UNet {key}={given[key]!r} is not ported yet (the port "
                    f"serves {key}={want!r}; see ROADMAP.md)"
                )
        self.n_classes = n_classes
        depth, ks, st = list(depth), list(kernel_sizes), list(strides)
        self.n_levels = len(depth)
        adn_fn = get_adn_fn(
            norm_type, activation_fn, dropout_param, dropout_type
        )

        in_ch = in_channels
        for i, d in enumerate(depth):
            self.add_module(f"enc_{i}", _ConvUnit(in_ch, d, ks[i], 1, adn_fn))
            if i < len(depth) - 1:
                self.add_module(
                    f"enc_ds_{i}", _ConvUnit(d, d, ks[i], st[i], adn_fn)
                )
            in_ch = d
        curr_ch = depth[-1]
        for i, (d, k, s) in enumerate(
            zip(depth[-2::-1], ks[-2::-1], st[-2::-1])
        ):
            self.add_module(f"link_{i}", ResidualBlock(d, 3, d, adn_fn))
            self.add_module(
                f"up_{i}", ConvTranspose3d(curr_ch, d, _tuple(s, 3))
            )
            self.add_module(f"dec_{i}", _ConvUnit(2 * d, d, k, 1, adn_fn))
            curr_ch = d
        d0 = depth[0]
        self.Conv_0 = Conv3d(d0, d0, _tuple(3, 3))
        self.final_adn = adn_fn(d0)
        n_out = n_classes if n_classes > 2 else 1
        self.Conv_1 = Pointwise(d0, n_out)
        add_heads(self, adn_fn, n_out, depth[-1], depth[-2::-1],
                  bottleneck_classification, deep_supervision)

    def forward(self, x, return_logits: bool = False,
                heads: bool = True):
        encoding_out = []
        curr = x
        for i in range(self.n_levels):
            curr = getattr(self, f"enc_{i}")(curr)
            encoding_out.append(curr)
            if i < self.n_levels - 1:
                curr = getattr(self, f"enc_ds_{i}")(curr)
        bottleneck, deep_outputs = curr, []
        for i in range(self.n_levels - 1):
            encoded = getattr(self, f"link_{i}")(encoding_out[-i - 2])
            curr = getattr(self, f"up_{i}")(curr)
            if curr.shape[1:-1] != encoded.shape[1:-1]:
                raise NotImplementedError(
                    f"decoder level {i}: upsampled {tuple(curr.shape[1:-1])}"
                    f" != skip {tuple(encoded.shape[1:-1])}; the resize the "
                    "JAX UNet applies here is not ported yet (use spatial "
                    "sizes divisible by the product of the strides)"
                )
            curr = getattr(self, f"dec_{i}")(torch.cat([curr, encoded], -1))
            deep_outputs.append(curr)
        y = apply_adn(self.final_adn, self.Conv_0(curr))
        y = self.Conv_1(y)
        if not return_logits:
            y = (torch.softmax(y, -1) if self.n_classes > 2
                 else torch.sigmoid(y))
        return with_heads(self, y, bottleneck, deep_outputs, heads)
