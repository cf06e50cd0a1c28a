"""
Host-side deterministic preprocessing for training and prediction.

The port's own copy of ``resample_to_spec``, ``area_resize``,
``nearest_resize``, ``center_crop_pad``, ``precompute_fg_indices``, the spacing-inference
helpers and ``make_load_fn`` from ``adell_mri_tpu/transforms/host.py``.
The resample is one ``scipy.ndimage.map_coordinates`` call per volume (the
JAX package's scipy path; its optional native resampler is not used).
"""

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

from adell_mri_torch.data.nifti import NiftiImage, read_nifti, reorient_to_ras

logger = logging.getLogger(__name__)

#: ADC maps above 1e3 are rescaled by this factor instead of min-max scaled
ADC_FACTOR = -2 / 3


def spacing_values_from_dataset_json(
    dataset: Dict[str, dict], key: str, n: Optional[int] = None
) -> List[Tuple[float, ...]]:
    """Voxel spacings of the first ``n`` entries' ``key`` images, read
    from their NIfTI headers."""
    spacings = []
    for i, (pid, entry) in enumerate(dataset.items()):
        if n is not None and i >= n:
            break
        if key not in entry:
            continue
        try:
            img = read_nifti(entry[key])
        except (OSError, ValueError) as e:
            logger.warning("spacing read failed for %s: %s", pid, e)
            continue
        spacings.append(tuple(float(s) for s in img.spacing))
    return spacings


def get_spacing_quantile(
    spacings: List[Tuple[float, ...]], q: float = 0.5
) -> List[float]:
    """Per-axis quantile of spacings."""
    return [float(x) for x in np.quantile(np.asarray(spacings), q, axis=0)]


def resample_to_spec(
    img: NiftiImage,
    target_spacing: Optional[Sequence[float]] = None,
    target_size: Optional[Sequence[int]] = None,
    interp_order: int = 1,
    cval: float = 0.0,
) -> np.ndarray:
    """One composed resample: target grid -> center alignment -> spacing
    scale -> source voxel grid, i.e. Spacingd followed by a center
    pad/crop to ``target_size``, touching each voxel once. A 4D volume
    contributes its first channel."""
    data = img.data
    if data.ndim > 3:
        data = data[..., 0]
    spacing = img.spacing
    if target_spacing is None:
        target_spacing = spacing
    zoom = np.asarray(spacing, float) / np.asarray(target_spacing, float)
    resampled_shape = np.round(np.asarray(data.shape) * zoom).astype(int)
    if target_size is None:
        target_size = resampled_shape
    target_size = tuple(int(t) for t in target_size)
    # dst[i] samples src at (i + offset) / zoom
    offset = (resampled_shape - np.asarray(target_size)) / 2.0
    coords = np.indices(target_size).astype(np.float64)
    for d in range(3):
        coords[d] = (coords[d] + offset[d]) / zoom[d]
    return ndimage.map_coordinates(
        data.astype(np.float32), coords, order=min(interp_order, 1),
        cval=cval, mode="constant",
    ).astype(np.float32)


def precompute_fg_indices(
    label: np.ndarray, max_fg: int = 4096, seed: int = 0
) -> Tuple[np.ndarray, int]:
    """Foreground voxel coordinates for the pos/neg crop, padded to
    ``max_fg`` rows so that every sample has the same shape; a label with
    more foreground voxels keeps ``max_fg`` of them, drawn without
    replacement from ``seed``. Returns (indices [max_fg, ndim] int32, the
    number of valid rows)."""
    ndim = label.ndim
    fg = np.argwhere(label > 0)
    n = len(fg)
    if n == 0:
        return np.zeros((max_fg, ndim), np.int32), 0
    if n > max_fg:
        rng = np.random.default_rng(seed)
        fg = fg[rng.choice(n, size=max_fg, replace=False)]
        n = max_fg
    out = np.zeros((max_fg, ndim), np.int32)
    out[:n] = fg
    return out, n


def area_resize(vol: np.ndarray, out_shape: Sequence[int]) -> np.ndarray:
    """Adaptive-average ("area") resize, as torch's
    ``interpolate(mode="area")``: output cell i averages source indices
    [floor(i*in/out), ceil((i+1)*in/out)), from one integral image."""
    vol = np.asarray(vol, np.float64)
    out_shape = tuple(int(s) for s in out_shape)
    ndim = len(out_shape)
    integ = vol
    for ax in range(ndim):
        integ = np.cumsum(integ, axis=ax)
        pad = [(0, 0)] * integ.ndim
        pad[ax] = (1, 0)
        integ = np.pad(integ, pad)
    bounds = []
    for ax, out in enumerate(out_shape):
        n = vol.shape[ax]
        i = np.arange(out)
        lo = np.floor(i * n / out).astype(np.int64)
        hi = np.ceil((i + 1) * n / out).astype(np.int64)
        bounds.append((lo, hi))
    # inclusion-exclusion over the 2^ndim corners of each output box
    out = np.zeros(out_shape + vol.shape[ndim:], np.float64)
    count = np.ones(out_shape, np.float64)
    for ax, (lo, hi) in enumerate(bounds):
        shape = [1] * ndim
        shape[ax] = -1
        count = count * (hi - lo).reshape(shape)
    for corner in range(2**ndim):
        idx = []
        sign = 1.0
        for ax, (lo, hi) in enumerate(bounds):
            low_side = corner >> ax & 1
            idx.append(lo if low_side else hi)
            sign *= -1.0 if low_side else 1.0
        out = out + sign * integ[np.ix_(*idx)]
    count = count.reshape(out_shape + (1,) * (vol.ndim - ndim))
    return (out / count).astype(np.float32)


def nearest_resize(vol: np.ndarray, out_shape: Sequence[int]) -> np.ndarray:
    """Nearest-neighbour resize of the leading ``len(out_shape)`` axes,
    source index ``floor(i * in / out)`` (torch's ``nearest``)."""
    idx = tuple(
        np.minimum(np.floor(np.arange(o) * vol.shape[ax] / o),
                   vol.shape[ax] - 1).astype(np.int64)
        for ax, o in enumerate(out_shape)
    )
    return vol[np.ix_(*idx)]


def center_crop_pad(vol: np.ndarray, target: Sequence[int]) -> np.ndarray:
    """Center crop/pad of the leading len(target) axes."""
    for ax, t in enumerate(int(t) for t in target):
        s = vol.shape[ax]
        if s < t:
            pad = [(0, 0)] * vol.ndim
            pad[ax] = ((t - s) // 2, t - s - (t - s) // 2)
            vol = np.pad(vol, pad)
        elif s > t:
            lo = (s - t) // 2
            sl = [slice(None)] * vol.ndim
            sl[ax] = slice(lo, lo + t)
            vol = vol[tuple(sl)]
    return vol


def make_load_fn(
    image_keys: Sequence[str],
    label_keys: Optional[Sequence[str]] = None,
    target_spacing: Optional[Sequence[float]] = None,
    target_size: Optional[Sequence[int]] = None,
    adc_keys: Sequence[str] = (),
    positive_labels: Sequence[int] = (1,),
    max_fg: int = 4096,
    resize_size: Optional[Sequence[int]] = None,
):
    """The cached, deterministic part of a training sample: each image key
    read, RAS-oriented, resampled once to (``target_spacing``,
    ``target_size``) and min-max scaled (ADC keys conditionally rescaled
    instead), stacked channels-last; the label keys resampled with
    nearest, combined by max and binarized by ``positive_labels`` (the
    JAX trainer's label mode), with their foreground indices for the
    pos/neg crop (``fg_indices``, ``n_fg``). With ``resize_size`` each
    volume is resampled to the spacing alone, scaled to ``resize_size``
    (``area_resize``; labels ``nearest_resize``), then centre-cropped or
    padded to ``target_size``, the JAX order. 4D inputs are not ported
    yet."""
    label_keys = list(label_keys or [])

    def read(path):
        img = reorient_to_ras(read_nifti(path))
        if img.data.ndim > 3:
            raise NotImplementedError(
                f"{path}: 4D NIfTI inputs are not ported yet"
            )
        return img

    def spatial(img, resize, interp_order=1):
        if resize_size is None:
            return resample_to_spec(img, target_spacing, target_size,
                                    interp_order=interp_order)
        vol = resize(resample_to_spec(img, target_spacing, None,
                                      interp_order=interp_order),
                     resize_size)
        return vol if target_size is None else center_crop_pad(
            vol, target_size)

    def load_fn(entry: Dict) -> Dict:
        channels = []
        for key in image_keys:
            vol = spatial(read(entry[key]), area_resize)
            if key in adc_keys:
                if vol.max() > 1e3:
                    vol = vol * ADC_FACTOR
            else:
                lo, hi = vol.min(), vol.max()
                vol = (vol - lo) / max(hi - lo, 1e-6)
            channels.append(vol[..., None])
        sample = {
            "image": np.concatenate(channels, axis=-1).astype(np.float32),
            "identifier": entry.get("identifier", ""),
        }
        if label_keys:
            lab = np.stack([
                spatial(read(entry[key]), nearest_resize, interp_order=0)
                for key in label_keys
            ]).max(axis=0)
            lab = np.isin(np.round(lab).astype(np.int32),
                          np.asarray(positive_labels))
            sample["label"] = lab.astype(np.float32)
            fg, n_fg = precompute_fg_indices(sample["label"], max_fg)
            sample["fg_indices"] = fg
            sample["n_fg"] = np.int32(n_fg)
        return sample

    return load_fn
