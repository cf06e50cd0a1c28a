"""
Config-driven ResNet backbone.

Counterpart of ``ResNetBackbone`` in
``adell_mri_tpu/models/layers/res_net.py``: ``structure`` is a list of
(channels, inter_channels, kernel_size, n_blocks) stages and
``maxpool_structure`` each stage's pool window; the stem is a 7^3 conv,
ADN, a 3^3 conv, ADN and a max-pool of 2; a stage is ``max(n_blocks, 2)``
blocks of ``res_type`` (``RES_BLOCK_REGISTRY``: "resnet" bottleneck
residual blocks, "resnext", "convnext" or "convnextv2"; the first changes
the width to the stage's; a ConvNeXt block takes the stage's kernel, per
axis where the config gives a list, and no ADN), then, with
``batch_ensemble > 0``, a 1x1 batch-ensemble conv, then its pool. Module
names are the JAX tree's: ``Conv_0``, ``ActDropNorm_0``, ``Conv_1``,
``ActDropNorm_1``, ``ResidualBlock_{i}`` (``ResNeXtBlock_{i}``,
``ConvNeXtBlock_{i}``) counted over every stage,
``BatchEnsembleConv_{s}``. ``ndim`` is the number of spatial axes of the
input (3, or 2 for the 2D networks), which the JAX module reads from its
input; a pool given per axis must have that many entries (the JAX module
fails at its first call on a list of another length, this one when it is
built). ``forward(x, return_intermediate=True)`` also returns each
stage's output before its pool, with ``return_stem`` the stem's (before
its pool of 2) first: the U-Net encoder's skips.

``ProjectionHead`` and ``ResNet`` are the JAX module's of those names:
the head is Dense layers of ``structure`` (``Dense_{i}``), each hidden
one followed by its ADN (``ActDropNorm_{i}``), over the max-pooled input
where that is spatial; ``ResNet`` is the backbone (``ResNetBackbone_0``),
a global max pool (the representation), then an optional projection head
(``ProjectionHead_0``) followed by its LayerNorm (``LayerNorm_0``, eps
1e-6: flax's default), kept outside the head as the JAX module keeps it,
and an optional prediction head over the projection (the next
``ProjectionHead_{i}``); ``forward(x, ret)`` returns the
``"representation"``, ``"projection"`` or ``"prediction"``.
"""

from typing import Optional, Sequence, Tuple

import torch.nn as nn

from adell_mri_torch.models.layers.batch_ensemble import BatchEnsembleConv
from adell_mri_torch.models.layers.blocks import (
    GlobalPooling,
    _tuple,
    add_mlp,
    apply_adn,
    max_pool,
    run_mlp,
)
from adell_mri_torch.models.layers.res_blocks import RES_BLOCK_REGISTRY
from adell_mri_torch.ops.conv import Conv3d


class ResNetBackbone(nn.Module):
    def __init__(
        self,
        in_channels: int,
        structure: Sequence[Tuple[int, int, int, int]],
        maxpool_structure: Optional[Sequence] = None,
        adn_fn=None,
        res_type: str = "resnet",
        batch_ensemble: int = 0,
        ndim: int = 3,
    ):
        super().__init__()
        if res_type not in RES_BLOCK_REGISTRY:
            raise KeyError(f"res_type {res_type!r}: one of "
                           f"{', '.join(RES_BLOCK_REGISTRY)}")
        block = RES_BLOCK_REGISTRY[res_type]
        mp = list(maxpool_structure or [2] * len(structure))
        if len(mp) != len(structure):
            # zip would drop trailing stages and train a smaller network
            raise ValueError(
                f"maxpool_structure has {len(mp)} entries for "
                f"{len(structure)} backbone stages"
            )
        # the JAX module's max_pool takes _tuple(window, ndim)
        self.pools = [_tuple(p, ndim) for p in mp]

        def adn(features):
            return adn_fn(features) if adn_fn else None

        f = structure[0][0]
        self.Conv_0 = Conv3d(in_channels, f, (7,) * ndim)
        self.ActDropNorm_0 = adn(f)
        self.Conv_1 = Conv3d(f, f, (3,) * ndim)
        self.ActDropNorm_1 = adn(f)
        self.stages = []
        in_ch, block_idx = f, 0
        for stage_idx, (channels, inter, k, n_blocks) in enumerate(structure):
            names = []
            for _ in range(max(n_blocks, 2)):
                module = block(in_ch, k, channels, adn_fn, inter, ndim=ndim)
                name = f"{type(module).__name__}_{block_idx}"
                self.add_module(name, module)
                names.append(name)
                in_ch, block_idx = channels, block_idx + 1
            if batch_ensemble > 0:
                name = f"BatchEnsembleConv_{stage_idx}"
                self.add_module(name, BatchEnsembleConv(
                    channels, batch_ensemble, channels, adn_fn))
                names.append(name)
            self.stages.append(names)
        self.output_features = structure[-1][0]

    def forward(self, x, return_intermediate: bool = False,
                return_stem: bool = False):
        x = apply_adn(self.ActDropNorm_0, self.Conv_0(x))
        x = apply_adn(self.ActDropNorm_1, self.Conv_1(x))
        intermediates = [x] if return_stem else []
        x = max_pool(x, 2)
        for names, pool in zip(self.stages, self.pools):
            for name in names:
                x = getattr(self, name)(x)
            intermediates.append(x)
            x = max_pool(x, pool)
        if return_intermediate:
            return x, intermediates
        return x


class ProjectionHead(nn.Module):
    """Dense layers of ``structure``, the hidden ones each followed by
    ``adn_fn(width)`` (none without it), over ``[B, F]`` or the max pool
    of a spatial ``[B, *S, F]``."""

    def __init__(self, in_features: int, structure: Sequence[int],
                 adn_fn=None):
        super().__init__()
        structure = list(structure)
        self.pool = GlobalPooling()
        self.n_hidden = add_mlp(self, in_features, structure[:-1],
                                structure[-1], adn_fn)

    def forward(self, x):
        if x.dim() > 2:
            x = self.pool(x)
        return run_mlp(self, self.n_hidden, x)


RETURNS = ("representation", "projection", "prediction")


class ResNet(nn.Module):
    """The backbone, its max-pooled representation and the projection and
    prediction heads; ``head_adn_fn`` is the heads' (1-d) ADN."""

    def __init__(
        self,
        in_channels: int,
        backbone_structure: Sequence[Tuple[int, int, int, int]],
        maxpool_structure: Optional[Sequence] = None,
        adn_fn=None,
        head_adn_fn=None,
        res_type: str = "resnet",
        projection_head_structure: Optional[Sequence[int]] = None,
        prediction_head_structure: Optional[Sequence[int]] = None,
        batch_ensemble: int = 0,
        ndim: int = 3,
    ):
        super().__init__()
        self.ResNetBackbone_0 = ResNetBackbone(
            in_channels, [tuple(s) for s in backbone_structure],
            maxpool_structure=maxpool_structure, adn_fn=adn_fn,
            res_type=res_type, batch_ensemble=batch_ensemble, ndim=ndim)
        self.pool = GlobalPooling()
        width = self.ResNetBackbone_0.output_features
        heads = 0
        self.proj = self.pred = None
        if projection_head_structure is not None:
            self.proj = f"ProjectionHead_{heads}"
            self.add_module(self.proj, ProjectionHead(
                width, projection_head_structure, head_adn_fn))
            heads, width = heads + 1, projection_head_structure[-1]
            self.LayerNorm_0 = nn.LayerNorm(width, eps=1e-6)
        if prediction_head_structure is not None:
            self.pred = f"ProjectionHead_{heads}"
            self.add_module(self.pred, ProjectionHead(
                width, prediction_head_structure, head_adn_fn))
            width = prediction_head_structure[-1]
        self.output_features = width

    def forward(self, x, ret: str = "projection"):
        if ret not in RETURNS:
            raise ValueError(f"ret must be one of {RETURNS}, not {ret!r}")
        # every head runs whatever ``ret`` asks for, as in the JAX module,
        # so that a training forward moves every head's running statistics
        rep = self.pool(self.ResNetBackbone_0(x))
        proj = rep
        if self.proj is not None:
            proj = self.LayerNorm_0(getattr(self, self.proj)(rep))
        pred = proj if self.pred is None else getattr(self, self.pred)(proj)
        return {"representation": rep, "projection": proj,
                "prediction": pred}[ret]
