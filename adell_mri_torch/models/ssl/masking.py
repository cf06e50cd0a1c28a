"""
Block masking of a token grid (I-JEPA's target blocks).

Counterpart of ``block_masking`` in ``adell_mri_tpu/models/ssl/masking.py``
with the same static-extent rule: each of ``n_blocks`` blocks takes, per
axis, an extent of ``grid * f`` tokens (at least one), ``f`` uniform
between ``block_scale[0] ** (1 / ndim)`` and ``block_scale[1] ** (1 /
ndim)``, at a start uniform over the positions where it fits; the mask is
their union. The draws (``draw_block_masks``, two sets of uniforms in
[0, 1) on the generator's device) are apart from the mask they make
(``block_mask``), so that a test can hand it the JAX package's draws.
"""

from typing import Sequence, Tuple

import torch


def draw_block_masks(generator: torch.Generator, n_blocks: int, ndim: int):
    """(extent draws, start draws), each [n_blocks, ndim] in [0, 1)."""
    device = generator.device
    return (torch.rand((n_blocks, ndim), generator=generator, device=device),
            torch.rand((n_blocks, ndim), generator=generator, device=device))


def block_mask(grid: Sequence[int], size_draws, start_draws,
               block_scale: Tuple[float, float] = (0.1, 0.25)):
    """The flat {0, 1} f32 mask [prod(grid)] (1 = masked) of the blocks
    the draws place, computed in f32 as the JAX function computes it."""
    ndim = len(grid)
    device = size_draws.device
    lo = torch.tensor(block_scale[0] ** (1 / ndim), dtype=torch.float32,
                      device=device)
    hi = torch.tensor(block_scale[1] ** (1 / ndim), dtype=torch.float32,
                      device=device)
    g = torch.tensor(list(grid), dtype=torch.int32, device=device)
    frac = torch.maximum(lo, size_draws.float() * (hi - lo) + lo)
    sizes = (g.float() * frac).to(torch.int32).clamp_min(1)
    starts = (start_draws.float() * (g - sizes).float()).to(torch.int32)
    coords = torch.meshgrid(
        *[torch.arange(n, device=device) for n in grid], indexing="ij")
    mask = torch.zeros(tuple(grid), dtype=torch.bool, device=device)
    for i in range(size_draws.shape[0]):
        inside = torch.ones(tuple(grid), dtype=torch.bool, device=device)
        for d in range(ndim):
            inside &= ((coords[d] >= starts[i, d])
                       & (coords[d] < starts[i, d] + sizes[i, d]))
        mask |= inside
    return mask.reshape(-1).float()


def block_masking(generator: torch.Generator, grid: Sequence[int],
                  n_blocks: int = 4,
                  block_scale: Tuple[float, float] = (0.1, 0.25)):
    """A flat mask of ``n_blocks`` random blocks drawn from
    ``generator``, on its device."""
    return block_mask(grid, *draw_block_masks(generator, n_blocks,
                                              len(grid)), block_scale)
