"""
Segmentation and classification transform factories: cached host load,
device augmentation.

Counterpart of ``AugmentPolicy``, ``_augment_one``, ``_batch_intensity``,
``SegmentationTransforms``, ``ClassificationTransforms`` and
``SSLTransforms`` (3D; see its docstring) in
``adell_mri_tpu/transforms/pipeline.py``,
with every flag of the JAX package: ``intensity``, ``noise``, ``rbf``,
``affine``, ``shear``, ``flip``, ``blur``, ``distort``, ``lowres`` and
``trivial``. ``load_fn()`` is the deterministic host part, run once per
volume and cached; ``augment(generator, batch)`` carries all randomness on
the device: per sample one gather warp with the affine, the flips and the
elastic displacement folded in, Gibbs ringing, the bias field, blur, low
resolution and one TrivialAugment op, and with ``crop_size`` a pos/neg crop
(its foreground centres mapped through the inverse of the warp's matrix;
a classifier's crop is uniform), then one fused intensity kernel over the
whole batch.

A sample's augmentation is a draw (``draw_augment``: every gate and random
parameter, on the device) and a deterministic core (``apply_augment``), so
that a test can hand the core JAX's draws. As in the JAX package every
gated op is computed for every sample and selected by its gate
(``torch.where`` on a device bool: the host never waits for the card), and
the workhorse moves the image only, not the label.
"""

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from adell_mri_torch.ops.kernels.intensity import fused_intensity_aug_batch
from adell_mri_torch.transforms import intensity as I
from adell_mri_torch.transforms import spatial as S
from adell_mri_torch.transforms.augment import (
    AugmentationWorkhorse,
    generic_augments,
    mri_specific_augments,
)
from adell_mri_torch.transforms.host import make_load_fn
from adell_mri_torch.transforms.labels import (
    convex_hull,
    crop_from_mask,
    label_operator,
)

FLAGS = ("intensity", "noise", "rbf", "affine", "shear", "flip", "blur",
         "distort", "lowres", "trivial")
# the ranges of the JAX package's _augment_one: Gibbs keeps this share of
# the spectrum (MONAI's alpha (0.3, 0.6) is the truncated share), blur
# sigma, low-resolution zoom, and the bias and elastic coarse grids
GIBBS_ALPHA = (0.4, 0.7)
BLUR_SIGMA = (0.25, 1.5)
LOWRES_ZOOM = (0.8, 1.2)
COARSE_GRID = 4
BIAS_MAGNITUDE = 0.3
# DINO's local crops: zoom range (the JAX SSLTransforms' local_crop_range
# default, which no caller changes); their size is half the view's
LOCAL_CROP_RANGE = (0.3, 0.6)


@dataclass
class AugmentPolicy:
    """Flag set and ranges of the augmentation, the JAX package's values
    (the reference's ``get_augmentations_unet``)."""

    intensity: bool = True
    noise: bool = True  # Rician + Gibbs
    rbf: bool = False  # bias field
    affine: bool = True
    shear: bool = False
    flip: bool = True
    blur: bool = False
    distort: bool = False  # elastic displacement in the warp
    lowres: bool = False  # simulated low resolution
    trivial: bool = False  # one TrivialAugment op per sample
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
    distort_prob: float = 0.2
    distort_magnitude: float = 2.0  # voxels
    lowres_prob: float = 0.2
    blur_prob: float = 0.1  # RandGaussianSmoothd's default
    flip_prob: float = 0.25  # per axis
    flip_axes: Tuple[int, ...] = (0,)

    @classmethod
    def from_flags(cls, flags: Sequence[str], **kw) -> "AugmentPolicy":
        flags = set(flags or [])
        return cls(**{n: n in flags for n in FLAGS}, **kw)

    @classmethod
    def classification(cls, flags: Sequence[str],
                       shape: Sequence[int]) -> "AugmentPolicy":
        """The classification CLI's policy (the JAX ``classification
        train``'s): probability 0.1, flips over the first two axes, a
        rotation of pi/16 about the first, scale 0.1, 0.1, 0.05 and a
        translation of 4, 4 and 1 voxels as a share of ``shape``, the
        augmented shape."""
        return cls.from_flags(
            flags, prob=0.1, flip_axes=(0, 1),
            rotate_range=(math.pi / 16, 0.0, 0.0),
            scale_range=(0.1, 0.1, 0.05),
            translate_range=tuple(v / s for v, s in zip((4.0, 4.0, 1.0),
                                                         shape)))


def _gate(generator, prob: float, device):
    return torch.rand((), generator=generator, device=device) < prob


def _folds_flips(policy: AugmentPolicy, ndim: int) -> bool:
    # flips fold into the warp's matrix only when an affine or shear warp
    # runs anyway
    return policy.flip and (policy.affine or policy.shear) and ndim == 3


def draw_augment(generator, image, policy: AugmentPolicy,
                 workhorse: Optional[AugmentationWorkhorse] = None) -> Dict:
    """Every random draw of one sample's augmentation (``image`` [*S, C]
    gives the shape and the device): the gates (device bools), the warp's
    matrix (output voxel -> input voxel, flips folded in), the elastic
    grid, the flip gates that are not folded, Gibbs' alpha, the bias grid,
    the blur sigma, the low-resolution zoom and the workhorse's picks."""
    ndim = image.dim() - 1
    shape = tuple(image.shape[:-1])
    dev = image.device
    d = {}
    if policy.distort:
        d["do_distort"] = _gate(generator, policy.distort_prob, dev)
        d["elastic_grid"] = S.draw_elastic_grid(
            generator, ndim, COARSE_GRID, policy.distort_magnitude, dev)
    if policy.affine or policy.shear or policy.distort:
        # each op fires with prob per sample; a sample where none does
        # warps with the exact identity (distort alone warps too)
        do_aff = _gate(generator, policy.prob, dev).float()
        do_shear = _gate(generator, policy.prob, dev).float()
        rot = S.host_vector(policy.rotate_range, dev)
        scl = S._per_axis(policy.scale_range, ndim, dev)
        trn = S._per_axis(policy.translate_range, ndim, dev)
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
        if _folds_flips(policy, ndim):
            gates = S._bernoulli(generator, policy.flip_prob,
                                 len(policy.flip_axes), dev)
            mat = mat @ S._flip_matrix(gates, shape, policy.flip_axes)
        d["matrix"] = mat
    if policy.flip and not _folds_flips(policy, ndim):
        d["flip_gates"] = S._bernoulli(generator, policy.flip_prob,
                                       len(policy.flip_axes), dev)
    if policy.noise:
        d["do_gibbs"] = _gate(generator, policy.prob, dev)
        d["gibbs_alpha"] = I._uniform(generator, *GIBBS_ALPHA, dev)
    if policy.rbf:
        d["do_rbf"] = _gate(generator, policy.prob, dev)
        d["bias_grid"] = I.draw_bias_grid(generator, image, COARSE_GRID,
                                          BIAS_MAGNITUDE)
    if policy.blur:
        d["do_blur"] = _gate(generator, policy.blur_prob, dev)
        d["blur_sigma"] = I._uniform(generator, *BLUR_SIGMA, dev)
    if policy.lowres:
        d["do_lowres"] = _gate(generator, policy.lowres_prob, dev)
        d["lowres_zoom"] = I._uniform(generator, *LOWRES_ZOOM, dev)
    if policy.trivial and workhorse is not None:
        d["trivial"] = workhorse.draw(generator, image)
    return d


def apply_augment(image, label, policy: AugmentPolicy, draws: Dict,
                  workhorse: Optional[AugmentationWorkhorse] = None):
    """One sample's augmentation from its ``draws``, in the JAX package's
    order: the warp (image linear, label nearest, the gated elastic
    displacement added to both), the flips not folded into it, Gibbs, the
    bias field, blur, low resolution, then the workhorse on the image.
    Image [*S, C] and label [*S] (or None) keep their dtypes. Returns them
    and the matrix mapping output voxel -> input voxel of the geometric
    ops, without the displacement (None when no geometry ran)."""
    shape = tuple(image.shape[:-1])
    in_dtype = image.dtype
    label_dtype = None if label is None else label.dtype
    geom = None
    if "matrix" in draws:
        displacement = None
        if "elastic_grid" in draws:
            displacement = (S.elastic_displacement(draws["elastic_grid"],
                                                   shape)
                            * draws["do_distort"])
        geom = draws["matrix"]
        image = S.warp_affine(image, geom, displacement=displacement)
        if label is not None:
            label = S.warp_affine(label[..., None], geom, method="nearest",
                                  displacement=displacement)[..., 0]
    if "flip_gates" in draws:
        # the flip follows the warp in output space
        gates, axes = draws["flip_gates"], policy.flip_axes
        image = S.apply_flips(image, gates, axes)
        flip_mat = S._flip_matrix(gates, shape, axes)
        geom = flip_mat if geom is None else geom @ flip_mat
        if label is not None:
            label = S.apply_flips(label, gates, axes)
    if policy.noise:
        image = torch.where(draws["do_gibbs"],
                            I.truncate_kspace(image, draws["gibbs_alpha"]),
                            image)
    if policy.rbf:
        image = torch.where(draws["do_rbf"],
                            I.apply_bias_field(image, draws["bias_grid"]),
                            image)
    if policy.blur:
        image = torch.where(draws["do_blur"],
                            I.gaussian_smooth(image, draws["blur_sigma"]),
                            image)
    if policy.lowres:
        image = torch.where(
            draws["do_lowres"],
            I.low_resolution_at(image, draws["lowres_zoom"]), image)
    if "trivial" in draws:
        image = workhorse.apply(image, draws["trivial"])
    image = image.to(in_dtype)
    if label is not None:
        label = label.to(label_dtype)
    return image, label, geom


def _augment_one(generator, image, label, policy: AugmentPolicy,
                 workhorse: Optional[AugmentationWorkhorse] = None):
    """One sample: image [*S, C], label [*S] or None; ``apply_augment`` of
    ``draw_augment``."""
    draws = draw_augment(generator, image, policy, workhorse)
    return apply_augment(image, label, policy, draws, workhorse)


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
    # scales each volume after the spacing, before the pad/crop to
    # target_size (``make_load_fn``)
    resize_size: Optional[Sequence[int]] = None
    # seeds the workhorse's host choice of op (not part of the cache key)
    seed: int = field(default=0, repr=False)

    def __post_init__(self):
        # built at the first batch, for its number of spatial axes
        self.workhorse = None

    def load_fn(self):
        return make_load_fn(
            image_keys=self.image_keys,
            label_keys=self.label_keys,
            target_spacing=self.target_spacing,
            target_size=self.target_size,
            adc_keys=self.adc_keys,
            positive_labels=self.positive_labels,
            max_fg=self.max_fg,
            resize_size=self.resize_size,
        )

    def augment(self, generator, batch: Dict) -> Dict:
        """``batch["image"]`` [B, *S, C] and ``batch["label"]`` [B, *S] on
        the device; draws from ``generator`` (on the same device). A crop
        takes ``batch["fg_indices"]`` [B, max_fg, 3] and ``batch["n_fg"]``
        [B] (the load function's), and drops them from the batch."""
        if self.augmentations.trivial and self.workhorse is None:
            self.workhorse = AugmentationWorkhorse(
                ndim=batch["image"].dim() - 2, seed=self.seed)
        images, labels = [], []
        for i, (img, lab) in enumerate(zip(batch["image"], batch["label"])):
            img, lab, geom = _augment_one(
                generator, img, lab, self.augmentations, self.workhorse
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


@dataclass
class ClassificationTransforms:
    """Host load of the images (read -> RAS -> spacing -> scale -> size)
    and of the scalar class label, then device augmentation of the images:
    per sample ``_augment_one``, then with ``crop_size`` a uniform random
    crop, then the batch's intensity pass.

    The label follows the JAX package's precedence: ``label_groups`` (a
    class a group), else ``positive_labels`` (1 for those, else 0), else
    ``possible_labels`` (their index), else the value as a float. An
    entry without ``label_key`` loads without a label (prediction).
    ``clinical_feature_keys``: the entry's values at these keys, each
    through ``float``, as ``features`` (float32 [F]), the tabular input
    of a ``HybridClassifier``. ``mask_key``: a mask loaded beside the
    images (nearest, binarised at 1); ``image_masking`` multiplies the
    images by its slice-wise convex hull, ``image_crop_from_mask`` crops
    them to its bounding box with a 16-voxel margin and pads or crops
    that back to ``target_size`` about its centre (masking first). The
    mask itself leaves the sample. ``resize_size`` scales each volume
    after the spacing (area for the images, nearest for the mask) before
    the crop or pad to ``target_size``, as the JAX load does."""

    image_keys: Sequence[str] = ("image",)
    label_key: Optional[str] = "label"
    target_spacing: Optional[Sequence[float]] = None
    target_size: Optional[Sequence[int]] = None
    resize_size: Optional[Sequence[int]] = None
    crop_size: Optional[Sequence[int]] = None
    adc_keys: Sequence[str] = ()
    augmentations: AugmentPolicy = field(default_factory=AugmentPolicy)
    positive_labels: Optional[Sequence] = None
    possible_labels: Optional[Sequence] = None
    label_groups: Optional[Sequence[Sequence]] = None
    clinical_feature_keys: Sequence[str] = ()
    mask_key: Optional[str] = None
    image_masking: bool = False
    image_crop_from_mask: bool = False
    # seeds the workhorse's host choice of op (not part of the cache key)
    seed: int = field(default=0, repr=False)

    def __post_init__(self):
        # built at the first batch, for its number of spatial axes
        self.workhorse = None

    def label_of(self, value):
        if self.label_groups is not None:
            return label_operator(value, self.possible_labels or (),
                                  label_groups=self.label_groups)
        if self.positive_labels is not None:
            return str(value) in {str(v) for v in self.positive_labels}
        if self.possible_labels is not None:
            return label_operator(value, self.possible_labels)
        return float(value)

    def load_fn(self):
        import numpy as np

        base = make_load_fn(
            image_keys=self.image_keys,
            label_keys=[self.mask_key] if self.mask_key else None,
            target_spacing=self.target_spacing,
            target_size=self.target_size,
            adc_keys=self.adc_keys,
            resize_size=self.resize_size,
        )

        def load(entry):
            sample = base(entry)
            if self.mask_key:
                mask = sample.pop("label")
                sample.pop("fg_indices")
                sample.pop("n_fg")
                if self.image_masking:
                    sample["image"] = (sample["image"]
                                       * convex_hull(mask)[..., None])
                if self.image_crop_from_mask:
                    sample["image"] = crop_from_mask(
                        sample["image"], mask, output_size=self.target_size,
                        margin=16)
            if self.label_key is not None and self.label_key in entry:
                sample["label"] = np.float32(
                    self.label_of(entry[self.label_key]))
            if self.clinical_feature_keys:
                sample["features"] = np.asarray(
                    [float(entry[k]) for k in self.clinical_feature_keys],
                    np.float32)
            return sample

        return load

    def augment(self, generator, batch: Dict) -> Dict:
        """``batch["image"]`` [B, *S, C] on the device; draws from
        ``generator`` (on the same device). The labels pass through."""
        if self.augmentations.trivial and self.workhorse is None:
            self.workhorse = AugmentationWorkhorse(
                ndim=batch["image"].dim() - 2, seed=self.seed)
        images = []
        for img in batch["image"]:
            img, _, _ = _augment_one(generator, img, None,
                                     self.augmentations, self.workhorse)
            if self.crop_size is not None:
                img = S.random_crop(generator, img, tuple(self.crop_size))
            images.append(img)
        out = dict(batch)
        out["image"] = _batch_intensity(
            generator, torch.stack(images), self.augmentations
        )
        return out


def crop_matrix(shape: Sequence[int], crop_size: Sequence[int], zoom,
                position):
    """The output-voxel -> input-volume matrix of a scaled crop: a
    ``crop_size`` view of a ``shape`` volume at ``zoom`` (a 0-dim f32
    tensor), centred, then moved by ``position`` ([ndim] in [-1, 1)) times
    the half slack on each axis, so that it stays in bounds."""
    ndim = len(shape)
    dev = zoom.device
    mat = (S.center_matrix(shape, +1.0, dev)
           @ S.scale_shear_matrix(ndim, zoom.float().expand(ndim).clone())
           @ S.center_matrix(crop_size, -1.0, dev))
    half_slack = (S.host_vector(list(shape), dev)
                  - zoom * S.host_vector(list(crop_size), dev)) / 2.0
    shift = position * half_slack.clamp_min(0.0)
    mat = mat.clone()
    mat[:ndim, ndim] = mat[:ndim, ndim] + shift
    return mat


@dataclass
class SSLTransforms:
    """Two augmented views of each volume for the two-view methods, VICRegL
    and DINO.

    The host load is ``make_load_fn``'s (read, RAS, spacing, min-max
    scale, ``target_size``). On the device, each view of each sample is a
    TrivialAugment pass of ``n_transforms`` ops from the 27-op registry,
    then, with ``crop_size``, a random scaled crop at a random position
    (``crop_matrix``: zoom uniform in ``scaled_crop_range``) resampled
    through ``warp_affine``; ``view1`` for every sample, then ``view2``.
    ``image`` is kept at the base size. With ``expose_boxes`` (VICRegL)
    each view's output-voxel -> input-volume matrix comes as
    ``view{1,2}_mat`` [B, ndim + 1, ndim + 1] (the identity without
    ``crop_size``) and the registry is cut to the ops that move no voxel
    (``generic_augments`` and ``mri_specific_augments``), so that the
    matrix is the view's only geometry. With ``n_local_crops`` (DINO) each
    sample also gets that many local crops, ``local_crops`` [B, n, *small,
    C]: a TrivialAugment pass and a scaled crop of half the view's size at
    a zoom uniform in ``LOCAL_CROP_RANGE``. A view is a draw (``draw_view``) and a
    deterministic core (``view``, ``view_and_matrix``), so that a test can
    hand the core the JAX package's draws. 2D slices and
    ``sample_channels`` are not ported yet, nor are 4D inputs."""

    image_keys: Sequence[str] = ("image",)
    target_spacing: Optional[Sequence[float]] = None
    target_size: Optional[Sequence[int]] = None
    crop_size: Optional[Sequence[int]] = None
    adc_keys: Sequence[str] = ()
    sample_channels: Optional[int] = None
    slice_2d: bool = False
    n_transforms: int = 3
    scaled_crop_range: Tuple[float, float] = (0.6, 1.0)
    n_local_crops: int = 0
    expose_boxes: bool = False
    # seeds the workhorse's host choice of op (not part of the cache key)
    seed: int = field(default=0, repr=False)

    def __post_init__(self):
        unported = [name for name, on in (
            ("slice_2d (2D SSL)", self.slice_2d),
            ("sample_channels", self.sample_channels is not None)) if on]
        if unported:
            raise NotImplementedError(
                f"SSLTransforms: {', '.join(unported)} not ported yet "
                "(ROADMAP Queue 1, item 4)")
        self.workhorse = None

    def load_fn(self):
        return make_load_fn(
            image_keys=self.image_keys,
            target_spacing=self.target_spacing,
            target_size=self.target_size,
            adc_keys=self.adc_keys,
        )

    def _workhorse(self, ndim: int) -> AugmentationWorkhorse:
        if self.workhorse is None:
            names = (list(generic_augments) + list(mri_specific_augments)
                     if self.expose_boxes else None)
            self.workhorse = AugmentationWorkhorse(
                names, n_transforms=self.n_transforms, ndim=ndim,
                seed=self.seed)
        return self.workhorse

    def local_size(self, image_shape) -> Tuple[int, ...]:
        """The local crops' size for an ``image`` [*S, C]: half the
        view's."""
        return tuple(max(1, s // 2) for s in (self.crop_size
                                              or image_shape[:-1]))

    def draw_view(self, generator, image, local: bool = False):
        """One view's draws for ``image`` [*S, C] (a local crop's with
        ``local``): the workhorse's picks and, where the view is cropped,
        (zoom, position) uniforms in [0, 1)."""
        ndim = image.dim() - 1
        picks = self._workhorse(ndim).draw(generator, image)
        if self.crop_size is None and not local:
            return picks, None
        u = torch.rand((ndim + 1,), generator=generator,
                       device=image.device)
        return picks, (u[0], u[1:])

    def view_and_matrix(self, image, picks, crop=None, local: bool = False):
        """(the view of ``image`` the draws make, its output-voxel ->
        input-volume matrix): zoom ``lo + u (hi - lo)`` and position ``2 u
        - 1``, in f32 as ``jax.random.uniform`` maps its draws."""
        ndim = image.dim() - 1
        image = self._workhorse(ndim).apply(image, picks)
        if crop is None:
            return image, torch.eye(ndim + 1, device=image.device)
        size = self.local_size(image.shape) if local else tuple(
            self.crop_size)
        u_zoom, u_pos = crop
        lo, hi = (np.float32(v) for v in (
            LOCAL_CROP_RANGE if local else self.scaled_crop_range))
        zoom = (u_zoom.float() * float(hi - lo) + float(lo)).clamp_min(
            float(lo))
        position = (u_pos.float() * 2.0 - 1.0).clamp_min(-1.0)
        mat = crop_matrix(image.shape[:-1], size, zoom, position)
        return S.warp_affine(image, mat, out_shape=size), mat

    def view(self, image, picks, crop=None, local: bool = False):
        """The view of ``image`` the draws make (``view_and_matrix``)."""
        return self.view_and_matrix(image, picks, crop, local)[0]

    def augment(self, generator, batch: Dict) -> Dict:
        """``batch["image"]`` [B, *S, C] on the device; adds ``view1`` and
        ``view2`` [B, *crop, C] (with ``expose_boxes`` their matrices, with
        ``n_local_crops`` the local crops), drawing from ``generator``."""
        out = dict(batch)
        for name in ("view1", "view2"):
            views = [self.view_and_matrix(img, *self.draw_view(generator,
                                                               img))
                     for img in batch["image"]]
            out[name] = torch.stack([v for v, _ in views])
            if self.expose_boxes:
                out[f"{name}_mat"] = torch.stack([m for _, m in views])
        if self.n_local_crops > 0:
            out["local_crops"] = torch.stack([
                torch.stack([
                    self.view(img, *self.draw_view(generator, img,
                                                   local=True), local=True)
                    for img in batch["image"]])
                for _ in range(self.n_local_crops)], dim=1)
        return out
