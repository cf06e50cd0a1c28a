"""
Sliding-window segmentation inference.

Counterpart of ``adell_mri_tpu/inference/sliding_window.py``: the same
tile grid (strided starts plus a last tile flush against each edge), the
same micro-batches padded with zero-weight repeats of the last tile, the
same f32 overlap-add and the same static overlap counts. Where the JAX
package scans the micro-batches inside one compiled program, the port runs
them as an eager loop.
"""

import itertools
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from adell_mri_torch.ops.kernels.conv import same_conv_weights


def sliding_window_grid(
    spatial: Sequence[int],
    window: Sequence[int],
    stride: Optional[Sequence[int]] = None,
    stride_frac: float = 0.5,
) -> np.ndarray:
    """Tile starts with edge re-alignment: strides of ``stride_frac *
    window`` (or absolute ``stride``) and a final tile flush against each
    edge. Returns [n_tiles, ndim] int32."""
    if stride is None:
        if not 0.0 < stride_frac <= 1.0:
            # a fraction > 1 would leave interior voxels covered by no tile
            raise ValueError(
                f"stride fraction must be in (0, 1], got {stride_frac} — "
                "pass absolute strides via `stride` (voxels per axis)"
            )
        stride = [max(1, int(w * stride_frac)) for w in window]
    for w, st in zip(window, stride):
        if st > w:
            raise ValueError(
                f"stride {st} exceeds window {w}: interior voxels would "
                "be covered by no tile"
            )
    axes: List[List[int]] = []
    for s, w, st in zip(spatial, window, stride):
        if w >= s:
            starts = [0]
        else:
            starts = list(range(0, s - w + 1, st))
            if starts[-1] != s - w:
                starts.append(s - w)
        axes.append(starts)
    return np.asarray(list(itertools.product(*axes)), np.int32)


def _padded_tiles(spatial, window, stride_frac, chunk, stride=None):
    """Tile grid padded with repeats of the last tile (weight 0) to a
    multiple of ``chunk``, so every micro-batch has the same shape;
    returns (positions [N, ndim], valid [N])."""
    positions = sliding_window_grid(
        spatial, window, stride=stride, stride_frac=stride_frac
    )
    n_tiles = len(positions)
    pad = (-n_tiles) % chunk
    if pad:
        positions = np.concatenate(
            [positions, np.tile(positions[-1:], (pad, 1))]
        )
    valid = np.concatenate(
        [np.ones(n_tiles, np.float32), np.zeros(pad, np.float32)]
    )
    return positions, valid


def overlap_counts(
    spatial, window, positions: np.ndarray, valid: np.ndarray
) -> np.ndarray:
    """Per-voxel tile-overlap counts [*S, 1]; they depend on the grid only."""
    cnt = np.zeros(tuple(spatial) + (1,), np.float32)
    for p, v in zip(positions, valid):
        if v <= 0:
            continue
        sl = tuple(slice(int(s), int(s) + w) for s, w in zip(p, window))
        cnt[sl] += 1.0
    return cnt


def _pad_to_window(vol, window):
    """Zero-pads axes smaller than the window up to it (the model always
    sees its window shape). Returns (padded vol, original spatial)."""
    spatial = tuple(vol.shape[:-1])
    pad = [max(0, w - s) for w, s in zip(window, spatial)]
    if any(pad):
        flat = [0, 0]  # channel axis (last) first, as F.pad counts
        for p in reversed(pad):
            flat += [0, p]
        vol = F.pad(vol, flat)
    return vol, spatial


def sliding_window_inference(
    fn: Callable[[torch.Tensor], torch.Tensor],
    vol: torch.Tensor,
    window: Sequence[int],
    stride_frac: float = 0.5,
    batch_size: int = 4,
    stride: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Runs ``fn`` ([b, *window, C] -> [b, *window, C_out]) over every tile
    of ``vol`` [*S, C] in micro-batches of ``batch_size`` and averages the
    overlaps in f32. The accumulator takes C_out from the first batch.
    ``fn`` must not change its conv weights: the 3xTF32 conv prepares each
    weight once for all the micro-batches (``same_conv_weights``)."""
    window = tuple(int(w) for w in window)
    vol, orig_spatial = _pad_to_window(vol, window)
    spatial = tuple(vol.shape[:-1])
    positions, valid = _padded_tiles(
        spatial, window, stride_frac, batch_size, stride=stride
    )
    acc = None
    with same_conv_weights():
        for start in range(0, len(positions), batch_size):
            pos = positions[start:start + batch_size]
            slices = [
                tuple(slice(int(s), int(s) + w) for s, w in zip(p, window))
                for p in pos
            ]
            preds = fn(torch.stack([vol[sl] for sl in slices])).float()
            if acc is None:
                acc = torch.zeros(
                    spatial + (preds.shape[-1],), dtype=torch.float32,
                    device=preds.device,
                )
            for sl, pred, v in zip(slices, preds,
                                   valid[start:start + batch_size]):
                if v > 0:  # padding tiles carry weight 0
                    acc[sl] += pred
    cnt = torch.from_numpy(overlap_counts(spatial, window, positions, valid))
    out = acc / cnt.to(acc.device).clamp_min(1.0)
    if spatial != orig_spatial:
        out = out[tuple(slice(0, s) for s in orig_spatial)]
    return out


class SlidingWindowSegmentation:
    """Object wrapper with the reference's constructor surface. ``stride``
    follows the reference's type convention: a float is a fraction of the
    window (1.0 = no overlap), an int or a sequence of ints is absolute
    voxels. With ``with_params``, ``inference_function(params, batch)`` and
    ``__call__(vol, params)``."""

    def __init__(
        self,
        sliding_window_size: Sequence[int],
        inference_function: Callable,
        stride: float = 0.5,
        batch_size: int = 4,
        with_params: bool = False,
    ):
        self.window = tuple(sliding_window_size)
        self.fn = inference_function
        if isinstance(stride, float):
            self.stride_frac, self.stride_abs = stride, None
        elif isinstance(stride, int):
            self.stride_frac = None
            self.stride_abs = tuple(min(stride, w) for w in self.window)
        else:  # sequence of ints, one per axis
            self.stride_frac = None
            self.stride_abs = tuple(
                min(int(s), w) for s, w in zip(stride, self.window)
            )
        self.batch_size = batch_size
        self.with_params = with_params

    def __call__(self, vol: torch.Tensor, params=None) -> torch.Tensor:
        """vol [*S, C], one case."""
        fn = self.fn
        if self.with_params:
            fn = lambda x: self.fn(params, x)  # noqa: E731
        kwargs = dict(window=self.window, batch_size=self.batch_size)
        if self.stride_abs is not None:
            kwargs["stride"] = self.stride_abs
        else:
            kwargs["stride_frac"] = self.stride_frac
        return sliding_window_inference(fn, vol, **kwargs)
