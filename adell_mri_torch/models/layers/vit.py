"""
Vision transformer layers.

Counterpart of ``adell_mri_tpu/models/layers/vit.py``:
``sinusoidal_positions``, ``MultiHeadAttention``, ``TransformerBlock``,
``TransformerBlockStack``, ``LinearEmbedding``, ``SeqPool``, ``ViT``,
``FactorizedViT`` and the SWIN classes (``window_partition``,
``window_unpartition``, ``swin_attention_mask``, ``SWINTransformerBlock``,
``SWINTransformerBlockStack``). Submodule and
parameter names keep the JAX tree paths (``q``, ``k``, ``v``, ``proj``,
``q_norm``, ``k_norm``, ``LayerNorm_{0,1}``, ``MultiHeadAttention_0``,
``Dense_{i}``, ``block_{i}``, ``Conv_0``, ``embed_norm``,
``pos_embedding``, ``class_token``, ``registers``, ``SeqPool``'s
``Dense_0``, ``FactorizedViT``'s ``within_slice``, ``between_slice`` and
``slice_class_token``), so
``interop/from_flax.py`` maps a JAX checkpoint key for key. flax modules
learn their input sizes at the first call; these take them as constructor
arguments. Every LayerNorm has eps 1e-5. ``SliceLinearEmbedding`` (the
2.5D transformers' per-slice embedding: ``embed``, ``pos_embedding``,
``class_token``) takes the slice size ``(H, W)`` for its positions.
"""

import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from adell_mri_torch.models.layers.blocks import _tuple
from adell_mri_torch.models.layers.dropout import Dropout
from adell_mri_torch.ops.conv import Conv3d, lecun_normal_
from adell_mri_torch.ops.kernels.attention import flash_attention

# token count from which unbiased, dropout-free attention goes to the
# blockwise kernel instead of the materialised softmax: the JAX package's
# dispatch, kept as it is (where the two cross over on the H100 has not
# been measured)
FLASH_MIN_TOKENS = 2048


def sinusoidal_positions(n: int, dim: int) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32)[:, None]
    half = (dim + 1) // 2
    div = torch.exp(
        torch.arange(half, dtype=torch.float32) * (-math.log(10000.0) / half)
    )
    pe = torch.zeros((n, dim))
    pe[:, 0::2] = torch.sin(pos * div)[:, : pe[:, 0::2].shape[1]]
    pe[:, 1::2] = torch.cos(pos * div)[:, : pe[:, 1::2].shape[1]]
    return pe


@functools.lru_cache(maxsize=None)
def sinusoidal_positions_on(n: int, dim: int, device) -> torch.Tensor:
    """``sinusoidal_positions(n, dim)[None]`` on ``device``, computed once
    for each token count, width and device."""
    return sinusoidal_positions(n, dim)[None].to(device)


def patchify(x, patch: Sequence[int]) -> torch.Tensor:
    """``[B, *S, C]`` -> ``[B, N, prod(patch) C]``: the non-overlapping
    patches in grid order, each flattened as ``(*patch, C)``."""
    b, ndim = x.shape[0], x.dim() - 2
    grid = [s // p for s, p in zip(x.shape[1:-1], patch)]
    shape = [b]
    for g, p in zip(grid, patch):
        shape += [g, p]
    # [B, g0, p0, g1, p1, (g2, p2), C] -> [B, g..., p..., C]
    order = ([0] + [1 + 2 * d for d in range(ndim)]
             + [2 + 2 * d for d in range(ndim)] + [1 + 2 * ndim])
    y = x.reshape(shape + [x.shape[-1]]).permute(order)
    return y.reshape(b, math.prod(grid), -1)


def _dense(in_features: int, out_features: int) -> nn.Linear:
    """flax's ``Dense``: lecun-normal kernel, zero bias."""
    layer = nn.Linear(in_features, out_features)
    lecun_normal_(layer.weight, in_features)
    nn.init.zeros_(layer.bias)
    return layer


def _token_param(*shape) -> nn.Parameter:
    """flax's ``truncated_normal(0.02)``: cut at two standard deviations."""
    return nn.Parameter(
        nn.init.trunc_normal_(torch.empty(shape), std=0.02, a=-0.04, b=0.04)
    )


class MultiHeadAttention(nn.Module):
    """Multi-head attention with an optional additive ``bias`` on the
    scores. Unbiased attention without active dropout on ``[B, N, C]``
    input with at least ``FLASH_MIN_TOKENS`` tokens goes through
    ``flash_attention`` (the hand-written kernels on CUDA tensors);
    everything else materialises the softmax in plain PyTorch, as the JAX
    package computes it outside any kernel. ``qk_norm``: one
    ``LayerNorm(head_dim)`` for q and one for k, shared across heads,
    applied after the head split."""

    def __init__(
        self,
        dim: int,
        n_heads: int,
        head_dim: Optional[int] = None,
        dropout: float = 0.0,
        use_flash: bool = True,
        qk_norm: bool = True,
        kv_dim: Optional[int] = None,
    ):
        super().__init__()
        self.n_heads = n_heads
        self.head_dim = head_dim or dim // n_heads
        self.use_flash = use_flash
        inner = self.head_dim * n_heads
        kv_dim = dim if kv_dim is None else kv_dim
        self.q = _dense(dim, inner)
        self.k = _dense(kv_dim, inner)
        self.v = _dense(kv_dim, inner)
        self.q_norm = self.k_norm = None
        if qk_norm:
            self.q_norm = nn.LayerNorm(self.head_dim, eps=1e-5)
            self.k_norm = nn.LayerNorm(self.head_dim, eps=1e-5)
        self.dropout = Dropout(dropout) if dropout > 0 else None
        self.proj = _dense(inner, dim)

    def forward(self, q_in, kv_in=None, bias=None):
        kv_in = q_in if kv_in is None else kv_in
        hd = self.head_dim

        def split(x):
            return x.reshape(x.shape[:-1] + (self.n_heads, hd))

        q = split(self.q(q_in))
        k, v = split(self.k(kv_in)), split(self.v(kv_in))
        if self.q_norm is not None:
            q, k = self.q_norm(q), self.k_norm(k)
        dropping = self.dropout is not None and self.training
        flash_ok = (
            self.use_flash
            and bias is None
            and not dropping
            and q_in.dim() == 3
            and q_in.shape[1] >= FLASH_MIN_TOKENS
        )
        # [..., N, H, Dh] -> [..., H, N, Dh]
        q, k, v = (t.transpose(-2, -3) for t in (q, k, v))
        if flash_ok:
            out = flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous()
            )
        else:
            attn = torch.matmul(
                q.float(), k.float().transpose(-1, -2)
            ) / math.sqrt(hd)
            if bias is not None:
                attn = attn + bias
            attn = torch.softmax(attn, dim=-1).to(v.dtype)
            if dropping:
                attn = self.dropout(attn)
            out = torch.matmul(attn.float(), v.float())
        out = out.to(q_in.dtype).transpose(-2, -3)
        return self.proj(out.reshape(out.shape[:-2] + (hd * self.n_heads,)))


class TransformerBlock(nn.Module):
    """Pre-LN attention + MLP block with the exact (erf) GELU.
    ``mlp_structure`` gives the hidden widths and overrides ``mlp_ratio``;
    ``attention_dim`` is the total attention width (token dim when
    None)."""

    def __init__(
        self,
        dim: int,
        n_heads: int,
        mlp_ratio: float = 4.0,
        dropout: float = 0.0,
        moe_experts: int = 0,
        mlp_structure: Optional[Sequence[int]] = None,
        qk_norm: bool = True,
        attention_dim: Optional[int] = None,
    ):
        super().__init__()
        if moe_experts > 0:
            raise NotImplementedError(
                "mixture-of-experts transformer blocks are not ported yet"
            )
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-5)
        self.MultiHeadAttention_0 = MultiHeadAttention(
            dim, n_heads,
            head_dim=attention_dim // n_heads if attention_dim else None,
            dropout=dropout, qk_norm=qk_norm,
        )
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=1e-5)
        widths = (
            tuple(mlp_structure) if mlp_structure
            else (int(dim * mlp_ratio),)
        )
        self.n_hidden = len(widths)
        in_features = dim
        for i, width in enumerate(widths):
            self.add_module(f"Dense_{i}", _dense(in_features, width))
            in_features = width
        self.add_module(f"Dense_{self.n_hidden}", _dense(in_features, dim))
        self.dropout = Dropout(dropout) if dropout > 0 else None

    def forward(self, x, bias=None):
        x = x + self.MultiHeadAttention_0(self.LayerNorm_0(x), bias=bias)
        y = self.LayerNorm_1(x)
        for i in range(self.n_hidden):
            y = F.gelu(getattr(self, f"Dense_{i}")(y))
            if self.dropout is not None:
                y = self.dropout(y)
        return x + getattr(self, f"Dense_{self.n_hidden}")(y)


class TransformerBlockStack(nn.Module):
    """``n_blocks`` blocks; with ``return_at`` also the outputs of those
    blocks (the UNETR skips)."""

    def __init__(
        self,
        dim: int,
        n_blocks: int,
        n_heads: int,
        mlp_ratio: float = 4.0,
        dropout: float = 0.0,
        moe_experts: int = 0,
        mlp_structure: Optional[Sequence[int]] = None,
        qk_norm: bool = True,
        attention_dim: Optional[int] = None,
    ):
        super().__init__()
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            self.add_module(f"block_{i}", TransformerBlock(
                dim, n_heads, mlp_ratio, dropout, moe_experts=moe_experts,
                mlp_structure=mlp_structure, qk_norm=qk_norm,
                attention_dim=attention_dim,
            ))

    def forward(self, x, return_at: Optional[Sequence[int]] = None):
        outs = []
        for i in range(self.n_blocks):
            x = getattr(self, f"block_{i}")(x)
            if return_at is not None and i in return_at:
                outs.append(x)
        if return_at is not None:
            return x, outs
        return x


class LinearEmbedding(nn.Module):
    """Patchify + embed + [class token] + [registers] + positional
    embedding: ``[B, *S, C]`` -> tokens ``[B, N(+extra), E]``. A learnt
    positional embedding fixes the token count, so the module is built for
    one ``spatial`` size and one ``in_channels``; the sinusoidal positions
    (``learnable_embedding=False``) follow the token count of each input,
    as the JAX module computes them per call (DINO's global views and
    local crops share one module). ``embed_method``
    "convolutional" (3D only: a kernel == stride VALID conv) or "linear"
    (patches flattened as ``(*patch, C)``, any rank)."""

    def __init__(
        self,
        in_channels: int,
        spatial: Sequence[int],
        patch_size: Sequence[int],
        embed_dim: int = 256,
        embed_method: str = "linear",
        use_class_token: bool = False,
        n_registers: int = 0,
        learnable_embedding: bool = True,
        dropout: float = 0.0,
        channel_to_token: bool = False,
        embed_norm: bool = False,
    ):
        super().__init__()
        spatial = tuple(int(s) for s in spatial)
        ndim = len(spatial)
        if isinstance(patch_size, (list, tuple)):
            p = tuple(int(v) for v in patch_size)[:ndim]
            if len(p) < ndim:
                p = p + (p[-1],) * (ndim - len(p))
        else:
            p = _tuple(patch_size, ndim)
        self.patch = p
        self.grid = tuple(s // pi for s, pi in zip(spatial, p))
        self.embed_dim = embed_dim
        self.channel_to_token = channel_to_token
        self.embed_method = embed_method
        self.embed_norm = None
        if channel_to_token:
            n_tok = in_channels
            self.Dense_0 = _dense(math.prod(spatial), embed_dim)
        elif embed_method == "convolutional":
            if ndim != 3:
                raise NotImplementedError(
                    "the convolutional patch embedding is ported for 3D "
                    "inputs"
                )
            n_tok = math.prod(self.grid)
            self.Conv_0 = Conv3d(
                in_channels, embed_dim, p, strides=p, padding="VALID"
            )
        elif embed_method == "linear":
            n_tok = math.prod(self.grid)
            features = math.prod(p) * in_channels
            if embed_norm:
                self.embed_norm = nn.LayerNorm(features, eps=1e-5)
            self.Dense_0 = _dense(features, embed_dim)
        else:
            raise ValueError(f"unknown embed_method {embed_method!r}")
        if learnable_embedding:
            self.pos_embedding = _token_param(1, n_tok, embed_dim)
        else:
            self.register_buffer(
                "sinusoidal", sinusoidal_positions(n_tok, embed_dim)[None],
                persistent=False,
            )
        self.class_token = (
            _token_param(1, 1, embed_dim) if use_class_token else None
        )
        self.registers = (
            _token_param(1, n_registers, embed_dim) if n_registers > 0
            else None
        )
        self.dropout = Dropout(dropout) if dropout > 0 else None

    def positions(self, n: int, device) -> torch.Tensor:
        """The sinusoidal positions of ``n`` tokens: the buffer built for
        ``spatial``, or ``sinusoidal_positions_on`` for another count."""
        if n == self.sinusoidal.shape[1]:
            return self.sinusoidal
        return sinusoidal_positions_on(n, self.embed_dim, device)

    @staticmethod
    def n_patches(spatial, patch_size):
        return math.prod(s // p for s, p in zip(spatial, patch_size))

    def forward(self, x):
        b = x.shape[0]
        if self.channel_to_token:
            tokens = self.Dense_0(
                x.reshape(b, -1, x.shape[-1]).transpose(1, 2)
            )
        elif self.embed_method == "convolutional":
            tokens = self.Conv_0(x).reshape(b, -1, self.embed_dim)
        else:
            y = patchify(x, self.patch)
            if self.embed_norm is not None:
                y = self.embed_norm(y)
            tokens = self.Dense_0(y)
        pos = (
            self.pos_embedding if hasattr(self, "pos_embedding")
            else self.positions(tokens.shape[1], tokens.device)
        )
        tokens = tokens + pos.to(tokens.dtype)
        extra = [
            t.to(tokens.dtype).expand(b, -1, -1)
            for t in (self.class_token, self.registers) if t is not None
        ]
        if extra:
            tokens = torch.cat(extra + [tokens], dim=1)
        if self.dropout is not None:
            tokens = self.dropout(tokens)
        return tokens


class SeqPool(nn.Module):
    """Attention-weighted pooling of tokens ``[B, N, E]`` -> ``[B, E]``: a
    Dense layer scores each token, a softmax over the tokens weighs
    them."""

    def __init__(self, dim: int):
        super().__init__()
        self.Dense_0 = _dense(dim, 1)

    def forward(self, x):
        return (x * torch.softmax(self.Dense_0(x), dim=1)).sum(1)


class ViT(nn.Module):
    """Embedding + transformer stack."""

    def __init__(
        self,
        in_channels: int,
        spatial: Sequence[int],
        patch_size: Sequence[int],
        embed_dim: int = 256,
        n_blocks: int = 4,
        n_heads: int = 4,
        mlp_ratio: float = 4.0,
        dropout: float = 0.0,
        embed_method: str = "linear",
        use_class_token: bool = False,
        n_registers: int = 0,
        moe_experts: int = 0,
        learnable_embedding: bool = True,
        embed_norm: bool = False,
        mlp_structure: Optional[Sequence[int]] = None,
    ):
        super().__init__()
        self.LinearEmbedding_0 = LinearEmbedding(
            in_channels, spatial, patch_size, embed_dim=embed_dim,
            embed_method=embed_method, use_class_token=use_class_token,
            n_registers=n_registers, dropout=dropout,
            learnable_embedding=learnable_embedding, embed_norm=embed_norm,
        )
        self.TransformerBlockStack_0 = TransformerBlockStack(
            embed_dim, n_blocks, n_heads, mlp_ratio, dropout,
            moe_experts=moe_experts, mlp_structure=mlp_structure,
        )

    def forward(self, x, return_at: Optional[Sequence[int]] = None):
        return self.TransformerBlockStack_0(
            self.LinearEmbedding_0(x), return_at=return_at
        )


class FactorizedViT(nn.Module):
    """Attention within each slice, then between the slices: ``[B, H, W, D,
    C]`` -> tokens ``[B, D (+1), E]``. Each of the ``D`` slices is embedded
    by a 2D linear ``LinearEmbedding`` of ``patch_size[:2]`` with a class
    token and goes through ``n_blocks // 2 or 1`` blocks
    (``within_slice``); each slice's class token, plus the sinusoidal
    position of its slice, is a token of the second stack of ``n_blocks -
    n_blocks // 2 or 1`` blocks (``between_slice``), behind a learnt
    ``slice_class_token`` when ``use_class_token``. Built for the slices'
    ``spatial`` size (H, W) and ``in_channels``; any number of slices.
    The slice positions are added in the tokens' dtype (the JAX package
    adds f32 ones, which promote a bf16 input of the second stack to
    f32)."""

    def __init__(
        self,
        in_channels: int,
        spatial: Sequence[int],
        patch_size: Sequence[int],
        embed_dim: int = 256,
        n_blocks: int = 4,
        n_heads: int = 4,
        mlp_ratio: float = 4.0,
        dropout: float = 0.0,
        use_class_token: bool = True,
    ):
        super().__init__()
        self.embed_dim = embed_dim
        self.LinearEmbedding_0 = LinearEmbedding(
            in_channels, tuple(spatial)[:2], tuple(patch_size)[:2],
            embed_dim=embed_dim, use_class_token=True,
        )
        self.within_slice = TransformerBlockStack(
            embed_dim, n_blocks // 2 or 1, n_heads, mlp_ratio, dropout)
        self.slice_class_token = (
            _token_param(1, 1, embed_dim) if use_class_token else None)
        self.between_slice = TransformerBlockStack(
            embed_dim, n_blocks - n_blocks // 2 or 1, n_heads, mlp_ratio,
            dropout)

    def forward(self, x):
        b, h, w, d, c = x.shape
        slices = x.permute(0, 3, 1, 2, 4).reshape(b * d, h, w, c)
        tokens = self.within_slice(self.LinearEmbedding_0(slices))
        rep = tokens[:, 0].reshape(b, d, self.embed_dim)
        rep = rep + sinusoidal_positions_on(
            d, self.embed_dim, x.device).to(rep.dtype)
        if self.slice_class_token is not None:
            rep = torch.cat([self.slice_class_token.to(rep.dtype).expand(
                b, -1, -1), rep], dim=1)
        return self.between_slice(rep)


# -- SWIN ---------------------------------------------------------------------


def window_partition(x, window: Sequence[int]):
    """``[B, *S, C]`` -> (``[B * nW, prod(window), C]``, the window grid):
    windows batch-major, then in row-major grid order."""
    b, spatial, c = x.shape[0], tuple(x.shape[1:-1]), x.shape[-1]
    ndim = len(spatial)
    grid = [s // w for s, w in zip(spatial, window)]
    shape = [b]
    for g, w in zip(grid, window):
        shape += [g, w]
    order = (
        [0]
        + [1 + 2 * d for d in range(ndim)]
        + [2 + 2 * d for d in range(ndim)]
        + [1 + 2 * ndim]
    )
    y = x.reshape(shape + [c]).permute(order)
    return y.reshape(b * math.prod(grid), math.prod(window), c), grid


def window_unpartition(y, grid, window, spatial):
    """The inverse of ``window_partition``."""
    ndim = len(spatial)
    c = y.shape[-1]
    b = y.shape[0] // math.prod(grid)
    y = y.reshape([b] + list(grid) + list(window) + [c])
    order = [0]
    for d in range(ndim):
        order += [1 + d, 1 + ndim + d]
    order += [1 + 2 * ndim]
    return y.permute(order).reshape([b] + list(spatial) + [c])


def swin_attention_mask(spatial, window, shift, device=None):
    """``[nW, N, N]`` f32 additive bias (0 or -1e9) that keeps tokens from
    attending across the boundaries the cyclic shift wrapped: tokens of
    one window attend to each other only when they came from the same
    region of the unshifted volume."""
    import itertools

    import numpy as np

    img = np.zeros(tuple(spatial), np.float32)
    regions = []
    for s, w, sh in zip(spatial, window, shift):
        regions.append(
            [slice(0, s)] if sh == 0
            else [slice(0, s - w), slice(s - w, s - sh), slice(s - sh, s)]
        )
    for i, combo in enumerate(itertools.product(*regions)):
        img[combo] = i
    ids, _ = window_partition(
        torch.from_numpy(img).to(device)[None, ..., None], window
    )
    ids = ids[..., 0]
    same = ids[:, :, None] == ids[:, None, :]
    return torch.where(same, 0.0, -1e9).to(torch.float32)


class SWINTransformerBlock(nn.Module):
    """Windowed attention block, shifted by half a window when ``shift``.
    The window is clamped to the input per axis; a shift applies only
    along axes the window does not span (there it would only add the wrap
    mask). The input is zero-padded to window multiples after the first
    LayerNorm, and the padded tokens take part in attention unmasked, as
    in the JAX package. Dropout applies to the attention probabilities
    only. The wrap mask, tiled over the batch, is built once per input
    shape and device and kept."""

    def __init__(self, dim: int, window_size: Sequence[int], n_heads: int,
                 shift: bool = False, mlp_ratio: float = 4.0,
                 dropout: float = 0.0):
        super().__init__()
        self.window_size = tuple(window_size)
        self.shift = shift
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-5)
        self.MultiHeadAttention_0 = MultiHeadAttention(
            dim, n_heads, dropout=dropout
        )
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=1e-5)
        hidden = int(dim * mlp_ratio)
        self.Dense_0 = _dense(dim, hidden)
        self.Dense_1 = _dense(hidden, dim)
        self._bias = {}

    def attention_bias(self, b, padded, window, shift, device):
        """The mask of ``swin_attention_mask`` tiled batch-major to
        ``[B * nW, 1, N, N]``, the order of ``window_partition``."""
        key = (b, padded, window, shift, device)
        if key not in self._bias:
            mask = swin_attention_mask(padded, window, shift, device)
            self._bias[key] = mask[:, None].repeat(b, 1, 1, 1)
        return self._bias[key]

    def forward(self, x):
        spatial = tuple(x.shape[1:-1])
        window = tuple(min(w, s) for w, s in zip(self.window_size, spatial))
        shift = tuple(
            w // 2 if (self.shift and w < s) else 0
            for w, s in zip(window, spatial)
        )
        dims = tuple(range(1, x.dim() - 1))
        y = self.LayerNorm_0(x)
        pad = tuple((-s) % w for s, w in zip(spatial, window))
        if any(pad):
            y = F.pad(y, [0, 0] + [v for p in reversed(pad) for v in (0, p)])
        padded = tuple(y.shape[1:-1])
        bias = None
        if any(shift):
            y = torch.roll(y, [-s for s in shift], dims)
            bias = self.attention_bias(x.shape[0], padded, window, shift,
                                       x.device)
        windows, grid = window_partition(y, window)
        y = self.MultiHeadAttention_0(windows, bias=bias)
        y = window_unpartition(y, grid, window, padded)
        if any(shift):
            y = torch.roll(y, list(shift), dims)
        if any(pad):
            y = y[(slice(None),) + tuple(slice(0, s) for s in spatial)]
        x = x + y
        y = self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_1(x))))
        return x + y


class SWINTransformerBlockStack(nn.Module):
    """Hierarchical SWIN encoder: the patchify conv (``Conv_0``, kernel ==
    stride == ``patch_size``, VALID), then per stage ``depths[s]`` blocks
    (odd ones shifted) and, between stages, a 2x2x2 stride-2 VALID merge
    conv (``merge{s}``) that doubles the width. 3D only. Returns the last
    stage's output and every stage's output (``feats``); ``widths`` holds
    their channel counts."""

    def __init__(self, in_channels: int, embed_dim: int = 48,
                 depths: Sequence[int] = (2, 2, 2),
                 n_heads: Sequence[int] = (3, 6, 12),
                 window_size: Sequence[int] = (4, 4, 4),
                 patch_size: Sequence[int] = (2, 2, 2),
                 dropout: float = 0.0):
        super().__init__()
        p = tuple(int(v) for v in patch_size)[:3]
        self.Conv_0 = Conv3d(in_channels, embed_dim, p, strides=p,
                             padding="VALID")
        self.depths = list(zip(depths, n_heads))
        self.widths = []
        dim = embed_dim
        for stage, (depth, heads) in enumerate(self.depths):
            for blk in range(depth):
                block = SWINTransformerBlock(
                    dim, tuple(window_size)[:3], heads, shift=blk % 2 == 1,
                    dropout=dropout,
                )
                self.add_module(f"stage{stage}_block{blk}", block)
            self.widths.append(dim)
            if stage < len(self.depths) - 1:
                self.add_module(f"merge{stage}", Conv3d(
                    dim, 2 * dim, (2, 2, 2), strides=(2, 2, 2),
                    padding="VALID",
                ))
                dim *= 2

    def forward(self, x):
        x = self.Conv_0(x)
        feats = []
        for stage, (depth, _) in enumerate(self.depths):
            for blk in range(depth):
                x = getattr(self, f"stage{stage}_block{blk}")(x)
            feats.append(x)
            if stage < len(self.depths) - 1:
                x = getattr(self, f"merge{stage}")(x)
        return x, feats


class SliceLinearEmbedding(nn.Module):
    """Per-slice patch embedding: ``[B, H, W, D, C]`` -> per-slice token
    sequences ``[B, D, n_patches (+1), E]``. Each of the D slices is cut
    into ``(ph, pw)`` patches, embedded by one Dense layer over the
    flattened patch (``embed_method="linear"``) or by a 2D conv of kernel
    and stride ``(ph, pw)`` (``"convolutional"``), both named ``embed``;
    every slice gets the same positions, learnt (``pos_embedding``,
    normal(0.02)) or sinusoidal, then, with ``use_class_token``, one
    shared class token (``class_token``, zeros) in front. ``E`` is
    ``embed_dim``, or ``ph * pw * C``."""

    def __init__(
        self,
        in_channels: int,
        image_size: Sequence[int],
        patch_size: Sequence[int],
        embed_dim: Optional[int] = None,
        embed_method: str = "linear",
        use_class_token: bool = False,
        learnable_embedding: bool = True,
        dropout: float = 0.0,
    ):
        super().__init__()
        h, w = tuple(image_size)[:2]
        ph, pw = tuple(patch_size)[:2]
        self.patch = (ph, pw)
        self.embed_method = embed_method
        dim = self.embed_dim = embed_dim or ph * pw * in_channels
        if embed_method == "convolutional":
            self.embed = Conv3d(in_channels, dim, (ph, pw), strides=(ph, pw))
            n = -(-h // ph) * -(-w // pw)
        else:
            self.embed = _dense(ph * pw * in_channels, dim)
            n = (h // ph) * (w // pw)
        self.n_patches = n
        if learnable_embedding:
            self.pos_embedding = nn.Parameter(
                nn.init.normal_(torch.empty(1, n, dim), std=0.02))
        else:
            self.pos_embedding = None
            self.register_buffer(
                "positions", sinusoidal_positions(n, dim)[None],
                persistent=False)
        self.class_token = (nn.Parameter(torch.zeros(1, 1, dim))
                            if use_class_token else None)
        self.dropout = Dropout(dropout) if dropout > 0 else None

    def forward(self, x):
        b, h, w, d, c = x.shape
        ph, pw = self.patch
        slices = x.permute(0, 3, 1, 2, 4).reshape(b * d, h, w, c)
        if self.embed_method == "convolutional":
            tok = self.embed(slices).reshape(b * d, -1, self.embed_dim)
        else:
            gh, gw = h // ph, w // pw
            tok = slices.reshape(b * d, gh, ph, gw, pw, c)
            tok = tok.permute(0, 1, 3, 2, 4, 5).reshape(
                b * d, gh * gw, ph * pw * c)
            tok = self.embed(tok)
        pos = (self.pos_embedding if self.pos_embedding is not None
               else self.positions)
        tok = tok + pos.to(tok.dtype)
        if self.class_token is not None:
            tok = torch.cat([self.class_token.to(tok.dtype).expand(
                b * d, -1, -1), tok], dim=1)
        if self.dropout is not None:
            tok = self.dropout(tok)
        return tok.reshape(b, d, tok.shape[1], self.embed_dim)
