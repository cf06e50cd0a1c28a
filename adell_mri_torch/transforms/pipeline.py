"""
Segmentation transform factory: cached host load, device augmentation.

Counterpart of ``AugmentPolicy``, ``_augment_one``, ``_batch_intensity``
and ``SegmentationTransforms`` in ``adell_mri_tpu/transforms/pipeline.py``.
``load_fn()`` is the deterministic host part, run once per volume and
cached; ``augment(generator, batch)`` carries all randomness on the
device: per sample one gather warp with the affine and the flips folded
into one matrix, Gibbs ringing and, with ``crop_size``, a pos/neg crop
(its foreground centres mapped through the inverse of the warp), then one
fused intensity kernel over the whole batch.

Ported flags: ``intensity``, ``noise``, ``affine``, ``shear``, ``flip``.
``rbf``, ``blur``, ``distort``, ``lowres``, ``trivial`` and resize are not
ported yet and raise ``NotImplementedError``.
"""

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from adell_mri_torch.ops.kernels.intensity import fused_intensity_aug_batch
from adell_mri_torch.transforms import intensity as I
from adell_mri_torch.transforms import spatial as S
from adell_mri_torch.transforms.host import make_load_fn

_UNPORTED_FLAGS = ("rbf", "blur", "distort", "lowres", "trivial")


@dataclass
class AugmentPolicy:
    """Flag set and ranges of the augmentation, the JAX package's values
    (the reference's ``get_augmentations_unet``). The ranges of the
    unported ops (distortion, low resolution, blur) are not carried."""

    intensity: bool = True
    noise: bool = True  # Rician + Gibbs
    rbf: bool = False
    affine: bool = True
    shear: bool = False
    flip: bool = True
    blur: bool = False
    distort: bool = False
    lowres: bool = False
    trivial: bool = False
    # per-op fire probability per sample (the reference's prob=0.2)
    prob: float = 0.2
    rotate_range: Tuple[float, float, float] = (
        0.39269908,  # pi/8
        0.39269908,  # pi/8
        0.19634954,  # pi/16
    )
    scale_range: Union[float, Tuple[float, ...]] = 0.1
    shear_range: float = 0.1
    translate_range: Union[float, Tuple[float, ...]] = 0.0
    gamma_range: Tuple[float, float] = (0.5, 1.5)
    scale_delta: float = 0.0
    shift_delta: float = 0.1
    std_shift: bool = True  # shift = factor * std(x)
    noise_std: float = 0.02
    flip_prob: float = 0.25  # per axis
    flip_axes: Tuple[int, ...] = (0,)

    @classmethod
    def from_flags(cls, flags: Sequence[str], **kw) -> "AugmentPolicy":
        flags = set(flags or [])
        names = ("intensity", "noise", "rbf", "affine", "shear", "flip",
                 "blur", "distort", "lowres", "trivial")
        return cls(**{n: n in flags for n in names}, **kw)

    def check_ported(self):
        unported = [f for f in _UNPORTED_FLAGS if getattr(self, f)]
        if unported:
            raise NotImplementedError(
                f"augmentations {unported} are not ported yet (the port "
                "has intensity, noise, affine, shear, flip)"
            )


def _gate(generator, prob: float, device):
    return torch.rand((), generator=generator, device=device) < prob


def _augment_one(generator, image, label, policy: AugmentPolicy):
    """One sample: image [*S, C], label [*S] or None. One warp for all
    geometry (label with nearest), then Gibbs ringing. Dtypes are kept.
    Returns the image, the label and the matrix mapping output voxel ->
    input voxel of the geometric ops (None when none ran)."""
    policy.check_ported()
    ndim = image.dim() - 1
    shape = tuple(image.shape[:-1])
    dev = image.device
    in_dtype = image.dtype
    label_dtype = None if label is None else label.dtype
    fold_flip = policy.flip and (policy.affine or policy.shear) and ndim == 3
    geom = None
    if policy.affine or policy.shear:
        # each op fires with prob per sample; a sample where it does not
        # warps with the exact identity
        do_aff = _gate(generator, policy.prob, dev).float()
        do_shear = _gate(generator, policy.prob, dev).float()
        rot = torch.as_tensor(policy.rotate_range, device=dev)
        scl = torch.as_tensor(policy.scale_range, device=dev)
        trn = torch.as_tensor(policy.translate_range, device=dev)
        mat = S.random_affine_matrix(
            generator,
            shape,
            rotate_range=rot * do_aff if policy.affine else 0.0,
            scale_range=scl * do_aff if policy.affine else 0.0,
            shear_range=(policy.shear_range * do_shear if policy.shear
                         else 0.0),
            translate_range=trn * do_aff,
            device=dev,
        )
        if fold_flip:
            mat = S.compose_flips(
                generator, mat, shape, policy.flip_axes,
                prob=policy.flip_prob,
            )
        geom = mat
        image = S.warp_affine(image, mat)
        if label is not None:
            label = S.warp_affine(label[..., None], mat, method="nearest")
            label = label[..., 0]
    if policy.flip and not fold_flip:
        # image and label flip with the same draws
        state = generator.get_state()
        image, flip_mat = S.random_flip_with_matrix(
            generator, image, policy.flip_axes, ndim, prob=policy.flip_prob
        )
        # the flip follows the warp in output space
        geom = flip_mat if geom is None else geom @ flip_mat
        if label is not None:
            generator.set_state(state)
            label = S.random_flip(generator, label, policy.flip_axes,
                                  prob=policy.flip_prob)
    if policy.noise:
        # MONAI alpha (0.3, 0.6) is the truncated share; ours is the
        # retained share
        do_gibbs = _gate(generator, policy.prob, dev)
        image = torch.where(
            do_gibbs, I.gibbs_ringing(generator, image, (0.4, 0.7)), image
        )
    image = image.to(in_dtype)
    if label is not None:
        label = label.to(label_dtype)
    return image, label, geom


def fg_through_geometry(fg, geom, shape: Sequence[int]):
    """Foreground voxels of the pre-warp label, ``fg`` [N, ndim], where
    the warp that samples its input at ``geom @ o`` puts them: at
    ``inv(geom) @ p``, rounded and clipped into ``shape``."""
    nd = len(shape)
    inv = torch.linalg.inv_ex(geom.float())[0]
    pts = fg.float() @ inv[:nd, :nd].T + inv[:nd, nd]
    hi = torch.tensor(shape, device=fg.device) - 1
    return torch.minimum(torch.round(pts).long().clamp_min(0), hi).int()


def _batch_intensity(generator, image, policy: AugmentPolicy):
    """Per-sample gamma + scale/shift + Rician noise over the whole batch:
    one launch of the fused kernel on the card."""
    if not (policy.intensity or policy.noise):
        return image
    return fused_intensity_aug_batch(
        generator,
        image,
        gamma_range=policy.gamma_range if policy.intensity else (1.0, 1.0),
        scale_delta=policy.scale_delta if policy.intensity else 0.0,
        shift_delta=policy.shift_delta if policy.intensity else 0.0,
        sigma=policy.noise_std if policy.noise else 0.0,
        rician=True,
        gamma_prob=policy.prob,
        shift_prob=policy.prob,
        noise_prob=policy.prob,
        std_shift=policy.std_shift,
    ).to(image.dtype)


@dataclass
class SegmentationTransforms:
    """Host load (read -> RAS -> spacing -> scale -> size), then device
    augmentation; with ``crop_size`` each sample is cut to a pos/neg crop
    (``pos_ratio`` of them centred on a foreground voxel) after its warp
    and before the batch's intensity pass."""

    image_keys: Sequence[str] = ("image",)
    label_keys: Sequence[str] = ("label",)
    target_spacing: Optional[Sequence[float]] = None
    target_size: Optional[Sequence[int]] = None
    adc_keys: Sequence[str] = ()
    positive_labels: Sequence[int] = (1,)
    augmentations: AugmentPolicy = field(default_factory=AugmentPolicy)
    crop_size: Optional[Sequence[int]] = None
    pos_ratio: float = 0.5
    max_fg: int = 4096

    def __post_init__(self):
        self.augmentations.check_ported()

    def load_fn(self):
        return make_load_fn(
            image_keys=self.image_keys,
            label_keys=self.label_keys,
            target_spacing=self.target_spacing,
            target_size=self.target_size,
            adc_keys=self.adc_keys,
            positive_labels=self.positive_labels,
            max_fg=self.max_fg,
        )

    def augment(self, generator, batch: Dict) -> Dict:
        """``batch["image"]`` [B, *S, C] and ``batch["label"]`` [B, *S] on
        the device; draws from ``generator`` (on the same device). A crop
        takes ``batch["fg_indices"]`` [B, max_fg, 3] and ``batch["n_fg"]``
        [B] (the load function's), and drops them from the batch."""
        images, labels = [], []
        for i, (img, lab) in enumerate(zip(batch["image"], batch["label"])):
            img, lab, geom = _augment_one(
                generator, img, lab, self.augmentations
            )
            if self.crop_size is not None:
                fg, n_fg = self._fg(batch, i, img)
                if geom is not None:
                    fg = fg_through_geometry(fg, geom, img.shape[:-1])
                img, lab, _ = S.pos_neg_crop(
                    generator, img, lab, tuple(self.crop_size), fg, n_fg,
                    self.pos_ratio,
                )
            images.append(img)
            labels.append(lab)
        out = dict(batch)
        out["image"] = _batch_intensity(
            generator, torch.stack(images), self.augmentations
        )
        out["label"] = torch.stack(labels)
        out.pop("fg_indices", None)
        out.pop("n_fg", None)
        return out

    def _fg(self, batch: Dict, i: int, image):
        if "fg_indices" in batch:
            return batch["fg_indices"][i], batch["n_fg"][i]
        # no foreground indices: every crop is uniform
        zeros = torch.zeros((self.max_fg, image.dim() - 1), dtype=torch.int32,
                            device=image.device)
        return zeros, torch.zeros((), dtype=torch.int32, device=image.device)
