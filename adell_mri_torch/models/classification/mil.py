"""
Multiple-instance learning over 2D slice encoders.

Counterpart of ``MILAttention``, ``MultipleInstanceClassifier`` and
``TransformableTransformer`` in
``adell_mri_tpu/models/classification/mil.py``. A volume ``[B, H, W, S,
C]`` is cut into its ``S`` slices along the third spatial axis, which go
through the slice encoder ``module`` as one batch of ``B * S`` 2D images
(``[b, H, W, C] -> [b, F]``, ``F = n_features``), then:

- ``MultipleInstanceClassifier``: gated attention pooling over the slices
  (``MILAttention_0``: ``a = softmax(w^T (tanh(V h) * sigmoid(U h)))``),
  Dense + relu layers of ``head_structure``, then the output Dense layer;
- ``TransformableTransformer``: an optional Dense layer to ``embed_dim``,
  a ``TransformerBlockStack`` over the slice tokens, ``SeqPool`` and the
  output Dense layer.

The output is one logit (binary) or ``n_classes``. Module names are the
JAX tree's (``module``, ``MILAttention_0/{V,U,w}``, ``Dense_{i}``,
``TransformerBlockStack_0/block_{i}``, ``SeqPool_0``), so
``interop/from_flax.py`` maps a JAX checkpoint key for key.
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn

from adell_mri_torch.models.classification.nets import out_features
from adell_mri_torch.models.layers.vit import (
    SeqPool,
    TransformerBlockStack,
    _dense,
)


def slice_features(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, S, C]`` -> the encoder's features of each slice,
    ``[B, S, F]``."""
    b, h, w, s, c = x.shape
    slices = x.permute(0, 3, 1, 2, 4).reshape(b * s, h, w, c)
    return module(slices).reshape(b, s, -1)


class MILAttention(nn.Module):
    """Gated attention pooling of instances ``[B, N, F]``: the pooled
    ``[B, F]`` and the weights ``[B, N]``."""

    def __init__(self, features: int, attention_dim: int = 128):
        super().__init__()
        self.V = _dense(features, attention_dim)
        self.U = _dense(features, attention_dim)
        self.w = _dense(attention_dim, 1)

    def forward(self, h):
        gate = torch.tanh(self.V(h)) * torch.sigmoid(self.U(h))
        a = torch.softmax(self.w(gate)[..., 0], dim=-1)
        return torch.einsum("bn,bnf->bf", a, h), a


class MultipleInstanceClassifier(nn.Module):
    def __init__(self, module: nn.Module, n_features: int,
                 n_classes: int = 2, attention_dim: int = 128,
                 head_structure: Sequence[int] = (64,)):
        super().__init__()
        self.module = module
        self.MILAttention_0 = MILAttention(n_features, attention_dim)
        self.n_hidden = len(head_structure)
        width = n_features
        for i, h in enumerate(head_structure):
            self.add_module(f"Dense_{i}", _dense(width, h))
            width = h
        self.add_module(f"Dense_{self.n_hidden}",
                        _dense(width, out_features(n_classes)))

    def forward(self, x, return_attention: bool = False):
        pooled, attn = self.MILAttention_0(slice_features(self.module, x))
        y = pooled
        for i in range(self.n_hidden):
            y = torch.relu(getattr(self, f"Dense_{i}")(y))
        logits = getattr(self, f"Dense_{self.n_hidden}")(y)
        if return_attention:
            return logits, attn
        return logits


class TransformableTransformer(nn.Module):
    def __init__(self, module: nn.Module, n_features: int,
                 n_classes: int = 2, n_blocks: int = 2, n_heads: int = 4,
                 embed_dim: Optional[int] = None):
        super().__init__()
        self.module = module
        # flax numbers the Dense layers in call order: the embedding, when
        # there is one, is Dense_0 and the output layer follows it
        n_dense = 0
        dim = n_features
        if embed_dim is not None:
            self.Dense_0 = _dense(n_features, embed_dim)
            dim, n_dense = embed_dim, 1
        self.embed = embed_dim is not None
        self.TransformerBlockStack_0 = TransformerBlockStack(
            dim, n_blocks, n_heads)
        self.SeqPool_0 = SeqPool(dim)
        self.out_name = f"Dense_{n_dense}"
        self.add_module(self.out_name, _dense(dim, out_features(n_classes)))

    def forward(self, x):
        tokens = slice_features(self.module, x)
        if self.embed:
            tokens = self.Dense_0(tokens)
        pooled = self.SeqPool_0(self.TransformerBlockStack_0(tokens))
        return getattr(self, self.out_name)(pooled)
