"""
3D (and 2D) convolution modules of the port.

Counterpart of ``adell_mri_tpu/ops/conv.py`` (``TpuConv``,
``TpuConvTranspose``, ``conv_transpose_block``). The JAX package picks
among TPU lowerings (z2d, im2col, Pallas, ...); none of them is carried
over. Here:

- a stride-1 3x3x3 SAME conv goes to the hand-written Hopper kernel
  ``conv3d_igemm`` at every shape, its input gradient too
  (``conv3d_igemm_train``; the plain version on CPU tensors);
- any other conv (the strided downsample convs with their explicit
  symmetric pads, the kernel == stride VALID patchify conv of the
  transformer embedding, other kernel sizes, dilated convs) is
  ``F.conv3d`` on a channels-last view, as the JAX package computes them
  outside any Pallas kernel; so is the depthwise conv (``DwConv``, the
  JAX package's ``TpuDwConv``: no Pallas kernel either);
- the kernel == stride transposed conv is one matmul plus a depth-to-space
  rearrange;
- a 1x1 conv is a plain product over the channel axis (``Pointwise``);
- a grouped conv (the ResNeXt block's) is a grouped ``F.conv3d``;
- a 2D conv (a two-tap ``kernel_size``: the 2D classifiers and the MIL
  slice encoder) is ``F.conv2d`` on a channels-last view, as the JAX
  package computes its 2D convs with XLA's conv and never with Pallas.

Tensors are channels-last ``[B, D, H, W, C]``. Weights are stored in the
layout each path reads without a copy: ``Conv3d.weight`` is
``[kd, kh, kw, Cin, Cout]`` (flax's layout, the kernel's [K, N] matrix),
``ConvTranspose3d.weight`` is ``[Cin, kd, kh, kw, Cout]`` with the taps in
output order (flax applies its kernel spatially flipped; the converter in
``interop/from_flax.py`` flips it once), ``Pointwise.weight`` is
``[Cout, Cin]``.
"""

from typing import Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from adell_mri_torch.ops.kernels.conv import conv3d_igemm_train

Padding = Union[str, Sequence[Tuple[int, int]]]


def _same_pads(spatial, k, strides, dilation=(1, 1, 1)):
    """TF/XLA SAME: output ceil(n/s), the odd pad on the high side."""
    pads = []
    for n, kk, s, r in zip(spatial, k, strides, dilation):
        out = -(-n // s)
        total = max((out - 1) * s + (kk - 1) * r + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def lecun_normal_(w, fan_in: int):
    """flax's ``lecun_normal``, the JAX package's kernel initialiser: a
    normal truncated at two standard deviations, scaled to variance
    ``1 / fan_in``."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def conv3d(x, w, bias=None, strides=(1, 1, 1), padding: Padding = "SAME",
           dilation=(1, 1, 1), groups: int = 1):
    """x [B,D,H,W,Cin], w [kd,kh,kw,Cin/groups,Cout] (or, in 2D, x
    [B,H,W,Cin] and w [kh,kw,Cin/groups,Cout]); ``padding`` is "SAME",
    "VALID" (none) or per-axis (low, high) pairs."""
    nd = w.dim() - 2
    k = tuple(w.shape[:nd])
    strides, dilation = tuple(strides)[:nd], tuple(dilation)[:nd]
    if (k == (3, 3, 3) and strides == (1, 1, 1) and padding == "SAME"
            and dilation == (1, 1, 1) and groups == 1):
        return conv3d_igemm_train(x.contiguous(), w, bias)
    if padding == "SAME":
        pads = _same_pads(x.shape[1:-1], k, strides, dilation)
    elif padding == "VALID":
        pads = [(0, 0)] * nd
    else:
        pads = [tuple(p) for p in padding]
    xc = x.movedim(-1, 1)
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if any(flat):
        xc = F.pad(xc, flat)
    conv = F.conv3d if nd == 3 else F.conv2d
    y = conv(xc, w.permute(nd + 1, nd, *range(nd)), bias, stride=strides,
             dilation=dilation, groups=groups)
    return y.movedim(1, -1)


class Conv3d(nn.Module):
    """Channels-last 3D conv with a ``[kd,kh,kw,Cin/groups,Cout]`` weight
    (the port's ``TpuConv``; with ``groups`` flax's grouped ``nn.Conv``,
    whose kernel layout is torch's: output channel ``o`` reads the
    ``o // (Cout / groups)``-th block of ``Cin / groups`` inputs). A
    two-tap ``kernel_size`` makes it the 2D conv, weight ``[kh,kw,Cin/
    groups,Cout]``, on ``[B, H, W, C]``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Sequence[int],
        strides: Sequence[int] = (1, 1, 1),
        padding: Padding = "SAME",
        dilation: Sequence[int] = (1, 1, 1),
        groups: int = 1,
    ):
        super().__init__()
        self.strides = tuple(strides)
        self.padding = padding
        self.dilation = tuple(dilation)
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(
            tuple(kernel_size) + (in_channels // groups, out_channels)))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        lecun_normal_(self.weight, self.weight.shape[:-1].numel())

    def forward(self, x):
        return conv3d(x, self.weight, self.bias, self.strides, self.padding,
                      self.dilation, self.groups)


class DwConv(nn.Module):
    """Channels-last depthwise 3D conv (the port's ``TpuDwConv``): one
    ``[kd,kh,kw]`` filter a channel, weight ``[kd,kh,kw,1,C]`` (flax's
    grouped-conv layout), bias ``[C]``; a grouped ``F.conv3d`` (with a
    two-tap ``kernel_size``, ``F.conv2d``)."""

    def __init__(self, channels: int, kernel_size: Sequence[int],
                 strides: Sequence[int] = (1, 1, 1),
                 padding: Padding = "SAME"):
        super().__init__()
        self.strides = tuple(strides)
        self.padding = padding
        self.weight = nn.Parameter(
            torch.empty(tuple(kernel_size) + (1, channels)))
        self.bias = nn.Parameter(torch.zeros(channels))
        lecun_normal_(self.weight, self.weight.shape[:-2].numel())

    def forward(self, x):
        return conv3d(x, self.weight, self.bias, self.strides, self.padding,
                      groups=self.weight.shape[-1])


def conv_transpose_block(x, w, bias):
    """Transposed conv with kernel == strides: ``out[b, z*sz+dz, y*sy+dy,
    x*sx+dx, co] = bias[co] + sum_ci x[b,z,y,x,ci] * w[ci,dz,dy,dx,co]``.
    The output blocks never overlap, so it is one [V, Cin] x
    [Cin, prod(k)*Cout] product and a depth-to-space rearrange."""
    cin, k, cout = w.shape[0], tuple(w.shape[1:4]), w.shape[4]
    b, sp = x.shape[0], tuple(x.shape[1:4])
    w2 = w.reshape(cin, -1)
    # the bias repeats for every (tap, co) column, added inside the product
    y = torch.addmm(bias.repeat(w2.shape[1] // cout), x.reshape(-1, cin), w2)
    y = y.reshape((b,) + sp + k + (cout,))
    y = y.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return y.reshape((b,) + tuple(s * kk for s, kk in zip(sp, k)) + (cout,))


class ConvTranspose3d(nn.Module):
    """Kernel == stride transposed conv (the port's ``TpuConvTranspose``)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Sequence[int],
    ):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty((in_channels,) + tuple(kernel_size) + (out_channels,))
        )
        self.bias = nn.Parameter(torch.zeros(out_channels))
        fan_in = in_channels * self.weight.shape[1:4].numel()
        lecun_normal_(self.weight, fan_in)

    def forward(self, x):
        return conv_transpose_block(x, self.weight, self.bias)


class Pointwise(nn.Module):
    """1x1 conv on channels-last tensors: a product over the channel axis
    with a ``[Cout, Cin]`` weight."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        lecun_normal_(self.weight, in_channels)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)
