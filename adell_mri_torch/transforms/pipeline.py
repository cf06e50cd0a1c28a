"""
Segmentation transform factory: cached host load, device augmentation.

Counterpart of ``AugmentPolicy``, ``_augment_one``, ``_batch_intensity``
and ``SegmentationTransforms`` in ``adell_mri_tpu/transforms/pipeline.py``.
``load_fn()`` is the deterministic host part, run once per volume and
cached; ``augment(generator, batch)`` carries all randomness on the
device: per sample one gather warp with the affine and the flips folded
into one matrix, Gibbs ringing, then one fused intensity kernel over the
whole batch.

Ported flags: ``intensity``, ``noise``, ``affine``, ``shear``, ``flip``.
``rbf``, ``blur``, ``distort``, ``lowres``, ``trivial``, random crops and
resize are not ported yet and raise ``NotImplementedError``.
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
    geometry (label with nearest), then Gibbs ringing. Dtypes are kept."""
    policy.check_ported()
    ndim = image.dim() - 1
    shape = tuple(image.shape[:-1])
    dev = image.device
    in_dtype = image.dtype
    label_dtype = None if label is None else label.dtype
    fold_flip = policy.flip and (policy.affine or policy.shear) and ndim == 3
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
        image = S.warp_affine(image, mat)
        if label is not None:
            label = S.warp_affine(label[..., None], mat, method="nearest")
            label = label[..., 0]
    if policy.flip and not fold_flip:
        # image and label flip with the same draws
        state = generator.get_state()
        image = S.random_flip(generator, image, policy.flip_axes,
                              prob=policy.flip_prob)
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
    return image, label


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
    augmentation of whole volumes (no random crop)."""

    image_keys: Sequence[str] = ("image",)
    label_keys: Sequence[str] = ("label",)
    target_spacing: Optional[Sequence[float]] = None
    target_size: Optional[Sequence[int]] = None
    adc_keys: Sequence[str] = ()
    positive_labels: Sequence[int] = (1,)
    augmentations: AugmentPolicy = field(default_factory=AugmentPolicy)

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
        )

    def augment(self, generator, batch: Dict) -> Dict:
        """``batch["image"]`` [B, *S, C] and ``batch["label"]`` [B, *S] on
        the device; draws from ``generator`` (on the same device)."""
        pairs = [
            _augment_one(generator, img, lab, self.augmentations)
            for img, lab in zip(batch["image"], batch["label"])
        ]
        out = dict(batch)
        out["image"] = _batch_intensity(
            generator, torch.stack([p[0] for p in pairs]),
            self.augmentations,
        )
        out["label"] = torch.stack([p[1] for p in pairs])
        return out
