"""
Self-supervised networks.

Counterpart of ``DINOHead``, ``NonContrastiveWrapper``,
``ViTMaskedAutoEncoder``, ``IJEPA``, ``DINO`` and ``IBOT`` in
``adell_mri_tpu/models/ssl/nets.py``, with the JAX tree's module names
(``backbone``, ``proj_{i}``, ``proj_norm``, ``pred_{i}``; ``embed``,
``ctx_mask_token``, ``context_encoder``, ``ctx2pred``, ``predictor``,
``pred_out``, ``target_encoder``; ``encoder``, ``head/Dense_{i}``,
``head/prototypes``, ``mask_token``; ``patch_embed``, ``enc2dec``,
``decoder``, ``reconstruct``), so ``interop/from_flax.py`` maps a JAX
checkpoint key for key. The sinusoidal positions are added in the
tokens' dtype (the JAX modules add f32 positions, which promote a bf16
input of the encoders to f32), as the mask tokens are blended in it.

- ``NonContrastiveWrapper``: a backbone's pooled features (a network built
  with ``feature_extraction``, ``n_features`` wide), the projection head
  (Dense layers with relu between), flax's LayerNorm (``proj_norm``), then
  the prediction head. ``ret`` picks what it returns: ``"prediction"``
  (the student of SimSiam and BYOL), ``"projection"`` (the teacher, and
  every side of VICReg, Barlow Twins and SimCLR) or ``"representation"``
  (the pooled features, what ``ssl predict_folder`` writes) or
  ``"local"`` (VICRegL: the normed projection of the feature map's mean,
  and the projection head applied at each position of the map, unnormed).
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
- ``DINOHead``: Dense layers with tanh-approximated GELU between
  (flax's ``nn.gelu`` default), the bottleneck Dense, the L2 norm, then
  the product with the prototypes normalised by column.
- ``DINO``: the convolutional patch embedding with sinusoidal positions
  for the input's token count (the same parameters serve the global views
  and the smaller local crops), the encoder, the token mean and the head.
- ``IBOT``: the same encoder and head; with ``mask=True`` the tokens of
  each sample's block mask (``masks`` [B, N], or drawn from
  ``generator``, one mask a sample) are replaced by ``mask_token``; it
  returns (the mean of the token logits, the token logits, the masks).
- ``ViTMaskedAutoEncoder``: patches flattened as ``(*patch, C)`` (the
  reconstruction targets), ``patch_embed`` with sinusoidal positions,
  ``masking.random_masking`` (the noise given or drawn from
  ``generator``), the encoder on the visible tokens, ``enc2dec``, the mask
  tokens appended and the order restored, positions again, the decoder and
  ``reconstruct``; it returns (predicted patches, target patches, mask).
"""

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from adell_mri_torch.models.layers.adn import LayerNorm
from adell_mri_torch.models.layers.regularization import L2NormalizationLayer
from adell_mri_torch.models.layers.vit import (
    LinearEmbedding,
    TransformerBlockStack,
    _dense,
    patchify,
    sinusoidal_positions_on,
)
from adell_mri_torch.models.ssl.masking import block_masking, random_masking

RETURNS = ("prediction", "projection", "representation", "local")


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
        if ret not in RETURNS:
            raise ValueError(f"ret must be one of {RETURNS}, not {ret!r}")
        if ret == "local":
            local = self.backbone(x, return_feature_map=True)
            feats = local.mean(dim=tuple(range(1, local.dim() - 1)))
            proj = self.proj_norm(self._head("proj", self.n_proj, feats))
            return proj, self._head("proj", self.n_proj, local)
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


class DINOHead(nn.Module):
    def __init__(self, in_features: int, out_dim: int = 4096,
                 hidden_dim: int = 512, bottleneck_dim: int = 128,
                 n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        width = in_features
        for i in range(n_layers - 1):
            self.add_module(f"Dense_{i}", _dense(width, hidden_dim))
            width = hidden_dim
        self.add_module(f"Dense_{n_layers - 1}",
                        _dense(width, bottleneck_dim))
        self.norm = L2NormalizationLayer()
        self.prototypes = nn.Parameter(
            torch.randn(bottleneck_dim, out_dim) * 0.02)

    def forward(self, x):
        for i in range(self.n_layers - 1):
            x = F.gelu(getattr(self, f"Dense_{i}")(x), approximate="tanh")
        x = self.norm(getattr(self, f"Dense_{self.n_layers - 1}")(x))
        protos = self.prototypes
        protos = protos / torch.linalg.vector_norm(
            protos, dim=0, keepdim=True).clamp_min(1e-8)
        return x @ protos.to(x.dtype)


class DINO(nn.Module):
    """Built for the global views' ``image_size``; takes any size whose
    axes the patch divides."""

    def __init__(
        self,
        in_channels: int = 1,
        image_size: Sequence[int] = (96, 96, 24),
        patch_size: Sequence[int] = (4, 4, 4),
        embed_dim: int = 192,
        n_blocks: int = 4,
        n_heads: int = 4,
        out_dim: int = 4096,
        hidden_dim: int = 512,
        bottleneck_dim: int = 128,
    ):
        super().__init__()
        self.patch = tuple(patch_size)[:len(image_size)]
        self.embed = LinearEmbedding(
            in_channels, image_size, self.patch, embed_dim=embed_dim,
            embed_method="convolutional", learnable_embedding=False)
        self.encoder = TransformerBlockStack(embed_dim, n_blocks, n_heads)
        self.head = DINOHead(embed_dim, out_dim, hidden_dim,
                             bottleneck_dim)

    def forward(self, x):
        return self.head(self.encoder(self.embed(x)).mean(dim=1))


class IBOT(DINO):
    def __init__(self, in_channels: int = 1,
                 image_size: Sequence[int] = (96, 96, 24),
                 patch_size: Sequence[int] = (4, 4, 4),
                 embed_dim: int = 192, n_blocks: int = 4, n_heads: int = 4,
                 out_dim: int = 4096, hidden_dim: int = 512,
                 bottleneck_dim: int = 128, n_mask_blocks: int = 4):
        super().__init__(in_channels, image_size, patch_size, embed_dim,
                         n_blocks, n_heads, out_dim, hidden_dim,
                         bottleneck_dim)
        self.n_mask_blocks = n_mask_blocks
        self.mask_token = nn.Parameter(torch.randn(1, 1, embed_dim) * 0.02)

    def grid(self, x):
        return [s // p for s, p in zip(x.shape[1:-1], self.patch)]

    def draw_masks(self, x, generator: torch.Generator):
        """One block mask a sample of ``x``, [B, N] f32."""
        return torch.stack([
            block_masking(generator, self.grid(x), self.n_mask_blocks)
            for _ in range(x.shape[0])])

    def forward(self, x, mask: bool = False, masks=None,
                generator: Optional[torch.Generator] = None):
        tokens = self.embed(x)
        b, n = tokens.shape[:2]
        if mask:
            if masks is None:
                if generator is None:
                    raise ValueError("IBOT needs masks or a generator to "
                                     "draw them")
                masks = self.draw_masks(x, generator)
            masks = masks.to(tokens.device)
            m = masks.to(tokens.dtype)[..., None]
            tokens = tokens * (1 - m) + self.mask_token.to(tokens.dtype) * m
        else:
            masks = torch.zeros((b, n), device=tokens.device)
        token_logits = self.head(self.encoder(tokens))
        return token_logits.mean(dim=1), token_logits, masks


class ViTMaskedAutoEncoder(nn.Module):
    def __init__(
        self,
        in_channels: int = 1,
        patch_size: Sequence[int] = (4, 4, 4),
        embed_dim: int = 192,
        n_blocks: int = 4,
        n_heads: int = 4,
        decoder_dim: int = 96,
        decoder_blocks: int = 2,
        mask_ratio: float = 0.75,
    ):
        super().__init__()
        self.patch = tuple(patch_size)
        self.mask_ratio = mask_ratio
        patch_dim = math.prod(self.patch) * in_channels
        self.patch_embed = _dense(patch_dim, embed_dim)
        self.encoder = TransformerBlockStack(embed_dim, n_blocks, n_heads)
        self.enc2dec = _dense(embed_dim, decoder_dim)
        self.mask_token = nn.Parameter(
            torch.randn(1, 1, decoder_dim) * 0.02)
        self.decoder = TransformerBlockStack(decoder_dim, decoder_blocks,
                                             n_heads)
        self.reconstruct = _dense(decoder_dim, patch_dim)

    def forward(self, x, noise=None,
                generator: Optional[torch.Generator] = None):
        target = patchify(x, self.patch)
        b, n, _ = target.shape
        tokens = self.patch_embed(target)
        tokens = tokens + sinusoidal_positions_on(
            n, tokens.shape[-1], tokens.device).to(tokens.dtype)
        if noise is None and generator is None:
            raise ValueError("ViTMaskedAutoEncoder needs noise or a "
                             "generator to draw it")
        visible, mask, restore = random_masking(tokens, self.mask_ratio,
                                                noise, generator)
        dec_in = self.enc2dec(self.encoder(visible))
        d = dec_in.shape[-1]
        full = torch.cat([dec_in, self.mask_token.to(dec_in.dtype).expand(
            b, n - dec_in.shape[1], -1)], dim=1)
        full = torch.gather(full, 1, restore[..., None].expand(-1, -1, d))
        full = full + sinusoidal_positions_on(n, d, full.device).to(
            full.dtype)
        return self.reconstruct(self.decoder(full)), target, mask
