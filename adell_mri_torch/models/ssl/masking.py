"""
Token masking: MAE's random masking and the block masking of a token
grid (I-JEPA's target blocks, iBOT's per-sample masks).

Counterpart of ``random_masking`` and ``block_masking`` in
``adell_mri_tpu/models/ssl/masking.py``. ``random_masking`` keeps
``max(1, int(n * (1 - ratio)))`` tokens of each sample: those of the
lowest noise, in the order of a stable argsort of the noise (the order
``jnp.argsort`` gives), with the permutation that restores the token
order; the noise is uniform in [0, 1), drawn from a generator or given
(a test hands it the JAX package's draws). ``block_masking`` has the
same static-extent rule as the JAX function: each of ``n_blocks`` blocks takes, per
axis, an extent of ``grid * f`` tokens (at least one), ``f`` uniform
between ``block_scale[0] ** (1 / ndim)`` and ``block_scale[1] ** (1 /
ndim)``, at a start uniform over the positions where it fits; the mask is
their union. The draws (``draw_block_masks``, two sets of uniforms in
[0, 1) on the generator's device) are apart from the mask they make
(``block_mask``), so that a test can hand it the JAX package's draws.
"""

from typing import Optional, Sequence, Tuple

import torch


def random_masking(tokens, mask_ratio: float = 0.75, noise=None,
                   generator: Optional[torch.Generator] = None):
    """``tokens`` [B, N, E] -> (visible tokens [B, n_keep, E], mask [B, N]
    f32 with 1 = masked, restore [B, N], the index of each token in the
    shuffled order). ``noise`` [B, N], else drawn from ``generator``."""
    b, n, e = tokens.shape
    n_keep = max(1, int(n * (1 - mask_ratio)))
    if noise is None:
        noise = torch.rand((b, n), generator=generator,
                           device=generator.device)
    noise = noise.to(tokens.device)
    shuffle = torch.argsort(noise, dim=1, stable=True)
    restore = torch.argsort(shuffle, dim=1, stable=True)
    visible = torch.gather(
        tokens, 1, shuffle[:, :n_keep, None].expand(-1, -1, e))
    shuffled = torch.cat([torch.zeros((b, n_keep), device=tokens.device),
                          torch.ones((b, n - n_keep), device=tokens.device)],
                         dim=1)
    return visible, torch.gather(shuffled, 1, restore), restore


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
