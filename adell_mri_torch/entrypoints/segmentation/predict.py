"""
``python -m adell_mri_torch segmentation predict``.

Counterpart of ``adell_mri_tpu/entrypoints/segmentation/predict.py`` for
unconditioned 3D checkpoints: the network (``net_type``: U-Net, UNETR or
SWIN-UNet, run without the heads of ``models/segmentation/heads.py``)
and the transforms are rebuilt from the checkpoint's metadata, the volume
runs through the sliding window (UNETR takes the whole volume as one
window: its positional embedding fixes the size), flip TTA, MC dropout
(``--mc_iterations``: the mean of that many training-mode forwards, the
dropout drawn from generators seeded with ``--seed``) and checkpoint
ensembling, the prediction is resampled back to the source geometry and
written as NIfTI in the background; ``--extract_lesions`` writes the
lesion-candidate map (dynamic threshold) in place of the probability map.
Conditioned and 2D checkpoints are not ported yet and raise.
"""

import glob
import json
import logging
import os

import numpy as np
import torch

from adell_mri_torch.config.factories import get_segmentation_network
from adell_mri_torch.data import Dataset, read_nifti, reorient_to_ras
from adell_mri_torch.data.nifti import reorient_from_ras
from adell_mri_torch.data.writer import AsyncNiftiWriter
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.eval.lesion import extract_lesion_candidates
from adell_mri_torch.inference import SegmentationInference
from adell_mri_torch.models.layers.adn import statistics_to_f32
from adell_mri_torch.models.layers.dropout import seed_dropout
from adell_mri_torch.train.checkpoints import CheckpointManager
from adell_mri_torch.train.precision import compute_dtype
from adell_mri_torch.transforms.host import (
    area_resize,
    center_crop_pad,
    resample_to_spec,
)

logger = logging.getLogger(__name__)

ARG_KEYS = [
    "dataset_json",
    ("image_keys", "image_keys", dict(required=False, default=None)),
    "prediction_ids",
    "checkpoint_dir",
    "checkpoint_name",
    "checkpoint",
    "output_path",
    "sliding_window_size",
    "sliding_window_stride",
    "flip_tta",
    "mc_iterations",
    "dev",
    "n_classes",
    "prediction_type",
    "segmentation_net_type",
    "precision",
    "seed",
]


def _select_fold(checkpoint_dir: str, name: str, fold: int) -> int:
    """``--fold -1`` picks the fold whose best.json has the best monitored
    value, in the direction the first fold's metadata records."""
    if fold >= 0:
        return fold
    candidates, modes = [], []
    for c in sorted(glob.glob(os.path.join(checkpoint_dir, f"{name}_fold*"))):
        bj = os.path.join(c, "best.json")
        if not os.path.exists(bj):
            continue
        with open(bj) as f:
            val = json.load(f).get("value")
        try:
            f_idx = int(c.rsplit("_fold", 1)[1])
        except ValueError:
            continue
        meta = os.path.join(c, "metadata.json")
        mode = None
        if os.path.exists(meta):
            with open(meta) as f:
                md = json.load(f)
            mode = md.get("mode") or (
                "min" if "loss" in md.get("monitor", "val_loss") else "max"
            )
        if val is not None:
            candidates.append((f_idx, val))
            modes.append(mode)
    if not candidates:
        logger.info("no fold best.json found, defaulting to fold 0")
        return 0
    known = [m for m in modes if m is not None]
    mode = known[0] if known else "min"
    best_fold, best_val = min(
        candidates, key=lambda fv: fv[1] if mode == "min" else -fv[1]
    )
    logger.info(
        "selected fold %d (best %s, mode %s)", best_fold, best_val, mode
    )
    return best_fold


def _load_volume(entry, image_keys, t_args):
    """Reads, RAS-orients, resamples and scales each key into a
    channels-last [*S, C] f32 volume, as the training load does."""
    target_spacing = t_args.get("target_spacing")
    target_size = t_args.get("target_size")
    resize_size = t_args.get("resize_size")
    adc_keys = set(t_args.get("adc_keys") or ())
    channels, ref_img, orig_affine = [], None, None
    for key in image_keys:
        raw = read_nifti(entry[key])
        if orig_affine is None:
            orig_affine = raw.affine.copy()
        img = reorient_to_ras(raw)
        ref_img = ref_img or img
        if resize_size:
            # Spacingd -> Resized(area) -> pad/crop
            vol = resample_to_spec(img, target_spacing, None)
            vol = area_resize(vol, resize_size)
            if target_size is not None and tuple(target_size) != tuple(
                resize_size
            ):
                vol = center_crop_pad(vol, target_size)
        else:
            vol = resample_to_spec(img, target_spacing, target_size)
        if key in adc_keys:
            # ADC conditional rescale, not min-max
            if vol.max() > 1e3:
                vol = vol * (-2.0 / 3.0)
            channels.append(vol)
        else:
            lo, hi = vol.min(), vol.max()
            channels.append((vol - lo) / max(hi - lo, 1e-6))
    x = np.stack(channels, axis=-1).astype(np.float32)
    return x, ref_img, orig_affine


def main(arguments):
    parser = Parser(prog="adell segmentation predict")
    parser.add_argument_by_key(ARG_KEYS)
    parser.add_argument(
        "--fold", type=int, default=0,
        help="checkpoint fold to predict with; -1 picks the fold with the "
        "best monitored value",
    )
    parser.add_argument(
        "--keep_ras", action="store_true",
        help="write predictions on the RAS grid instead of inverting back "
        "to the source file's voxel layout",
    )
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument(
        "--keep_largest_connected_component", action="store_true",
        help="binary predictions keep only the largest foreground component",
    )
    parser.add_argument(
        "--extract_lesions", action="store_true",
        help="write lesion-candidate maps (dynamic threshold) instead of "
        "probabilities",
    )
    args = parser.parse_args(arguments)

    device = use_device(args.dev)
    dtype = compute_dtype(args.precision) or torch.float32

    # checkpoint + metadata (transform args travel with the weights)
    name = args.checkpoint_name or "segmentation"
    fold = _select_fold(args.checkpoint_dir, name, args.fold)
    mngr = CheckpointManager(args.checkpoint_dir, name=name, fold=fold)
    metadata = mngr.load_metadata()
    net_cfg = metadata.get("network_config", {})
    t_args = metadata.get("transform_arguments", {})
    n_classes = metadata.get("n_classes", args.n_classes)
    net_type = metadata.get("net_type", args.segmentation_net_type)
    image_keys = args.image_keys or t_args.get("image_keys", ["image"])
    if int(net_cfg.get("spatial_dimensions", 3)) != 3:
        raise NotImplementedError("2D checkpoints are not ported yet")
    if t_args.get("skip_keys") or t_args.get("feature_keys"):
        raise NotImplementedError(
            "conditioned checkpoints (skip/feature keys) are not ported yet"
        )

    if args.checkpoint:
        managers = [
            CheckpointManager(
                os.path.dirname(p),
                name=os.path.basename(p).replace("_fold0", ""),
                fold=0,
            )
            for p in args.checkpoint
        ]
    else:
        managers = [mngr]
    models = []
    for i, m in enumerate(managers):
        # UNETR is built for the volume size it was trained at
        model = get_segmentation_network(
            net_type, net_cfg, n_classes=n_classes,
            image_size=t_args.get("target_size"),
        )
        model.load_state_dict(m.load_state_dict())
        model = statistics_to_f32(model.to(device=device, dtype=dtype))
        seed_dropout(model, torch.Generator(device=device).manual_seed(
            args.seed + i))
        models.append(model.eval())

    def base_fn(model, x, mc=False):
        # MC dropout: a training-mode forward, as the JAX CLI applies its
        # model with train=True and a dropout key
        model.train(mc)
        try:
            return model(x.to(dtype), heads=False).float()
        finally:
            model.eval()

    # the CLI flag is a float: values <= 1 are window fractions, values > 1
    # absolute voxels (int-typed downstream)
    sw_stride = args.sliding_window_stride
    if sw_stride > 1:
        sw_stride = int(sw_stride)
    inference = SegmentationInference(
        base_inference_function=base_fn,
        checkpoint_params=models,
        sliding_window_size=args.sliding_window_size,
        stride=sw_stride,
        flip=args.flip_tta,
        mc_iterations=args.mc_iterations,
    )

    data = Dataset(args.dataset_json)
    pids = args.prediction_ids or list(data.keys())
    target_spacing = t_args.get("target_spacing")
    resize_size = t_args.get("resize_size")
    os.makedirs(args.output_path, exist_ok=True)
    writer = AsyncNiftiWriter()
    try:
        for pid in pids:
            if pid not in data.dataset:
                continue
            x, ref_img, orig_affine = _load_volume(
                data[pid], image_keys, t_args
            )
            with torch.inference_mode():
                prob = inference(torch.from_numpy(x).to(device)).cpu().numpy()
            # binary: one sigmoid channel; multiclass: channel 0 is the
            # softmax background, so foreground = 1 - P(bg) and masks
            # come from the argmax over classes
            if n_classes and n_classes > 2:
                prob_fg = 1.0 - prob[..., 0]
                class_map = np.argmax(prob, axis=-1).astype(np.float32)
            else:
                prob_fg = prob[..., 0]
                class_map = None
            out = _invert_geometry(
                prob_fg, ref_img, target_spacing, resize_size=resize_size
            )
            out_cls = None
            if class_map is not None:
                out_cls = np.rint(
                    _invert_geometry(
                        class_map, ref_img, target_spacing,
                        resize_size=resize_size,
                    )
                )
            if args.keep_ras:
                affine = ref_img.affine
            else:
                # back to the source file's voxel layout
                out = reorient_from_ras(out, orig_affine)
                if out_cls is not None:
                    out_cls = reorient_from_ras(out_cls, orig_affine)
                affine = orig_affine
            out_path = os.path.join(args.output_path, f"{pid}_prob.nii.gz")
            if args.extract_lesions:
                cand_map, _, _ = extract_lesion_candidates(
                    out, threshold="dynamic"
                )
                writer.put(out_path, cand_map.astype(np.float32), affine)
            elif args.prediction_type == "probability":
                writer.put(out_path, out.astype(np.float32), affine)
            elif out_cls is not None:
                writer.put(out_path, out_cls.astype(np.uint8), affine)
            else:
                hard = (out > args.threshold).astype(np.uint8)
                if args.keep_largest_connected_component:
                    hard = _largest_component(hard)
                writer.put(out_path, hard, affine)
            logger.info("predicted %s -> %s", pid, out_path)
    finally:
        writer.close()


def _largest_component(hard: np.ndarray) -> np.ndarray:
    from scipy import ndimage

    labelled, n = ndimage.label(hard)
    if n <= 1:
        return hard
    sizes = ndimage.sum(hard, labelled, range(1, n + 1))
    return (labelled == (int(np.argmax(sizes)) + 1)).astype(np.uint8)


def _invert_geometry(pred, ref_img, target_spacing, resize_size=None):
    """Maps a prediction on the (spacing[, resize], size) grid back to the
    reference image's voxels. With ``resize_size`` the forward path scaled
    the spacing-resampled grid before any crop, and the inverse composes
    that scale into the coordinate map."""
    from scipy import ndimage

    orig_shape = ref_img.data.shape[:3]
    spacing = ref_img.spacing
    if target_spacing is None:
        target_spacing = spacing
    zoom = np.asarray(spacing, float) / np.asarray(target_spacing, float)
    resampled_shape = np.round(np.asarray(orig_shape) * zoom).astype(int)
    if resize_size is not None:
        scale = np.asarray(resize_size, float) / np.maximum(
            resampled_shape, 1
        )
        offset = (np.asarray(resize_size) - np.asarray(pred.shape)) / 2.0
    else:
        scale = np.ones(3)
        offset = (resampled_shape - np.asarray(pred.shape)) / 2.0
    coords = np.indices(orig_shape).astype(np.float32)
    for d in range(3):
        coords[d] = coords[d] * zoom[d] * scale[d] - offset[d]
    return ndimage.map_coordinates(pred, coords, order=1, mode="constant")
