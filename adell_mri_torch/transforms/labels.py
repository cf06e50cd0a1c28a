"""
Host-side mapping of scalar class labels, and the masks' host operations
of the classification pipeline.

The port's own copies of ``label_operator`` (its "cat" and group
mappings; the classification transforms binarize by ``positive_labels``
themselves), ``convex_hull`` and ``crop_from_mask`` from
``adell_mri_tpu/transforms/labels.py``, in numpy and scipy.
"""

from typing import Optional, Sequence, Union

import numpy as np


def label_operator(
    value,
    possible_labels: Sequence,
    label_groups: Optional[Sequence[Sequence]] = None,
) -> int:
    """``label_groups`` maps each group's members to the group's index;
    otherwise ``possible_labels`` map to 0..n-1. Values compare as
    strings; a list value takes its maximum."""
    if isinstance(value, (tuple, list)):
        value = max(value)
    if label_groups is not None:
        match = {
            str(label): i
            for i, group in enumerate(label_groups)
            for label in group
        }
    else:
        match = {str(v): i for i, v in enumerate(possible_labels)}
    return match[str(value)]


def convex_hull(mask: np.ndarray) -> np.ndarray:
    """Each 2D slice's foreground (above 0.5) filled to its convex hull,
    slice-wise along the last axis of a 3D mask (f32). A slice with fewer
    than three points, or a degenerate hull, keeps its foreground."""
    from scipy.spatial import ConvexHull, Delaunay, QhullError

    def hull_2d(sl):
        pts = np.stack(np.where(sl > 0.5), axis=1)
        if len(pts) < 3:
            return (sl > 0.5).astype(np.float32)
        try:
            hull = Delaunay(pts[ConvexHull(pts).vertices])
        except QhullError:
            return (sl > 0.5).astype(np.float32)
        grid = np.stack(
            np.meshgrid(*[np.arange(s) for s in sl.shape], indexing="ij"),
            axis=-1,
        ).reshape(-1, 2)
        inside = hull.find_simplex(grid) >= 0
        return inside.reshape(sl.shape).astype(np.float32)

    mask = np.asarray(mask)
    if mask.ndim == 2:
        return hull_2d(mask)
    out = np.zeros_like(mask, dtype=np.float32)
    for z in range(mask.shape[-1]):
        out[..., z] = hull_2d(mask[..., z])
    return out


def crop_from_mask(
    images: Union[np.ndarray, Sequence[np.ndarray]],
    mask: np.ndarray,
    output_size: Optional[Sequence[int]] = None,
    margin: int = 0,
):
    """The image(s) cropped to the mask's bounding box widened by
    ``margin`` voxels (clipped to the volume; no crop for an empty mask),
    then, with ``output_size``, zero-padded and centre-cropped to it."""
    mask = np.asarray(mask)
    fg = np.where(mask > 0.5)
    single = isinstance(images, np.ndarray)
    imgs = [images] if single else list(images)
    ndim = mask.ndim
    if len(fg[0]) == 0:
        out = imgs
    else:
        mins = [max(int(a.min()) - margin, 0) for a in fg]
        maxs = [min(int(a.max()) + 1 + margin, s)
                for a, s in zip(fg, mask.shape)]
        sl = tuple(slice(lo, hi) for lo, hi in zip(mins, maxs))
        out = [np.asarray(im)[sl + (Ellipsis,)] for im in imgs]
    if output_size is not None:
        resized = []
        for im in out:
            target = list(output_size) + list(im.shape[ndim:])
            pad = [(max((t - s) // 2, 0), max(t - s - max((t - s) // 2, 0), 0))
                   for s, t in zip(im.shape, target)]
            im = np.pad(im, pad)
            sl = tuple(slice((s - t) // 2, (s - t) // 2 + t)
                       for s, t in zip(im.shape, target))
            resized.append(im[sl])
        out = resized
    return out[0] if single else out
