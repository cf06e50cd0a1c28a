"""
Self-supervised networks.

Counterpart of ``NonContrastiveWrapper`` and ``IJEPA`` in
``adell_mri_tpu/models/ssl/nets.py``, with the JAX tree's module names
(``backbone``, ``proj_{i}``, ``proj_norm``, ``pred_{i}``; ``embed``,
``ctx_mask_token``, ``context_encoder``, ``ctx2pred``, ``predictor``,
``pred_out``, ``target_encoder``), so ``interop/from_flax.py`` maps a
JAX checkpoint key for key.

- ``NonContrastiveWrapper``: a backbone's pooled features (a network built
  with ``feature_extraction``, ``n_features`` wide), the projection head
  (Dense layers with relu between), flax's LayerNorm (``proj_norm``), then
  the prediction head. ``ret`` picks what it returns: ``"prediction"``
  (the student of SimSiam and BYOL), ``"projection"`` (the teacher, and
  every side of VICReg, Barlow Twins and SimCLR) or ``"representation"``
  (the pooled features, what ``ssl predict_folder`` writes). VICRegL's
  ``"local"`` is not ported yet.
- ``IJEPA``: the convolutional patch embedding with learnt positions
  (built for one image size, as the positions fix the token count), the
  context encoder on the tokens with the masked ones replaced by
  ``ctx_mask_token``, the predictor between ``ctx2pred`` and ``pred_out``,
  and the target encoder on the unmasked tokens, run without gradient
  (its features enter the loss detached; the step hands it the EMA of the
  context encoder where there is one). The mask is one block mask for the
  whole batch (``masking.block_masking``, drawn from ``generator``), or
  the ``mask`` given. It enters the blend in the tokens' dtype (the JAX
  module blends with an f32 mask, which promotes its bf16 context tokens
  to f32).
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from adell_mri_torch.models.layers.adn import LayerNorm
from adell_mri_torch.models.layers.vit import (
    LinearEmbedding,
    TransformerBlockStack,
    _dense,
)
from adell_mri_torch.models.ssl.masking import block_masking

RETURNS = ("prediction", "projection", "representation")


class NonContrastiveWrapper(nn.Module):
    def __init__(self, backbone: nn.Module,
                 projection_dims: Sequence[int] = (512, 128),
                 prediction_dims: Sequence[int] = (64, 128)):
        super().__init__()
        self.backbone = backbone
        self.n_proj, self.n_pred = len(projection_dims), len(prediction_dims)
        width = backbone.n_features
        for i, d in enumerate(projection_dims):
            self.add_module(f"proj_{i}", _dense(width, d))
            width = d
        self.proj_norm = LayerNorm(width)
        for i, d in enumerate(prediction_dims):
            self.add_module(f"pred_{i}", _dense(width, d))
            width = d

    def _head(self, stem: str, n: int, y):
        for i in range(n):
            y = getattr(self, f"{stem}_{i}")(y)
            if i < n - 1:
                y = F.relu(y)
        return y

    def forward(self, x, ret: str = "prediction"):
        if ret == "local":
            raise NotImplementedError(
                "ret='local' (VICRegL's local features) is not ported yet "
                "(ROADMAP Queue 1, item 4)")
        if ret not in RETURNS:
            raise ValueError(f"ret must be one of {RETURNS}, not {ret!r}")
        feats = self.backbone(x, return_features=True)
        if ret == "representation":
            return feats
        proj = self.proj_norm(self._head("proj", self.n_proj, feats))
        if ret == "projection":
            return proj
        return self._head("pred", self.n_pred, proj)


class IJEPA(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        image_size: Sequence[int] = (128, 128, 32),
        patch_size: Sequence[int] = (4, 4, 4),
        embed_dim: int = 192,
        n_blocks: int = 4,
        n_heads: int = 4,
        predictor_dim: int = 96,
        predictor_blocks: int = 2,
        n_target_blocks: int = 4,
    ):
        super().__init__()
        self.n_target_blocks = n_target_blocks
        self.embed = LinearEmbedding(
            in_channels, image_size, patch_size, embed_dim=embed_dim,
            embed_method="convolutional")
        self.grid = self.embed.grid
        self.ctx_mask_token = nn.Parameter(
            torch.randn(1, 1, embed_dim) * 0.02)
        self.context_encoder = TransformerBlockStack(embed_dim, n_blocks,
                                                     n_heads)
        self.ctx2pred = _dense(embed_dim, predictor_dim)
        self.predictor = TransformerBlockStack(predictor_dim,
                                               predictor_blocks, n_heads)
        self.pred_out = _dense(predictor_dim, embed_dim)
        self.target_encoder = TransformerBlockStack(embed_dim, n_blocks,
                                                    n_heads)

    def forward(self, x, mask=None,
                generator: Optional[torch.Generator] = None,
                encode_only: bool = False):
        """(predicted features [B, N, E], target features [B, N, E], mask
        [B, N]); with ``encode_only`` the target encoder's features of
        every token."""
        tokens = self.embed(x)
        if encode_only:
            return self.target_encoder(tokens)
        if mask is None:
            if generator is None:
                raise ValueError("IJEPA needs a mask or a generator to "
                                 "draw one")
            mask = block_masking(generator, self.grid, self.n_target_blocks)
        m = mask.to(device=tokens.device, dtype=tokens.dtype)[None, :, None]
        m = m.expand(tokens.shape[0], -1, 1)
        token = self.ctx_mask_token.to(tokens.dtype)
        ctx = self.context_encoder(tokens * (1 - m) + token * m)
        pred = self.predictor(self.ctx2pred(ctx))
        pred_f = self.pred_out(pred)
        with torch.no_grad():
            tgt = self.target_encoder(tokens)
        return pred_f, tgt, m[..., 0]

    def encode_target(self, x):
        return self(x, encode_only=True)
