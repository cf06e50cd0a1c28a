"""
``python -m adell_mri_torch segmentation test``.

Counterpart of ``adell_mri_tpu/entrypoints/segmentation/test.py``: the
network and the transforms are rebuilt from the checkpoint's
``metadata.json``, each test case runs through one whole-volume forward at
the checkpoint's ``target_size`` (no sliding window), and the mean Dice
and IoU (per foreground class on the argmax map when ``n_classes > 2``)
and, with ``--picai_eval``, the lesion-level AP, AUROC and PI-CAI score
(validation postprocess ``y > 0.1``) go to the metric CSV and to one JSON
line on standard output. ``--precision bf16`` casts the weights and the
inputs; the probabilities return to f32 before the metrics. A checkpoint
trained with ``--resize_size`` loads its cases resized as it trained.
Conditioned and 2D checkpoints are not ported yet and raise.
"""

import json

import numpy as np
import torch

from adell_mri_torch.config.factories import get_segmentation_network
from adell_mri_torch.data import Dataset
from adell_mri_torch.device import use_device
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.eval import evaluate as picai_evaluate
from adell_mri_torch.eval.metrics import dice_score, iou_score
from adell_mri_torch.models.layers.adn import statistics_to_f32
from adell_mri_torch.train.checkpoints import CheckpointManager
from adell_mri_torch.train.logging_utils import MetricLogger
from adell_mri_torch.train.precision import compute_dtype
from adell_mri_torch.transforms.pipeline import SegmentationTransforms

ARG_KEYS = [
    "dataset_json",
    ("image_keys", "image_keys", dict(required=False, default=None)),
    "mask_keys",
    "test_ids",
    "checkpoint_dir",
    "checkpoint_name",
    "n_classes",
    "picai_eval",
    "metric_path",
    "dev",
    "seed",
    "segmentation_net_type",
    "precision",
]


def case_metrics(prob_full: np.ndarray, label: np.ndarray, n_classes: int):
    """Dice, IoU and the foreground probability of one case's prediction
    [*S, C] against its label [*S]: with ``n_classes > 2`` channel 0 is the
    softmax background, so each foreground class is scored on the argmax
    map and the foreground is 1 - P(background)."""
    if n_classes and n_classes > 2:
        cls_map = np.argmax(prob_full, axis=-1)
        dices, ious = [], []
        for c in range(1, n_classes):
            hard = (cls_map == c).astype(np.float32)
            dices.append(dice_score(hard, label == c))
            ious.append(iou_score(hard, label == c))
        return (float(np.mean(dices)), float(np.mean(ious)),
                1.0 - prob_full[..., 0])
    prob = prob_full[..., 0]
    return dice_score(prob, label), iou_score(prob, label), prob


def main(arguments):
    parser = Parser(prog="adell segmentation test")
    parser.add_argument_by_key(ARG_KEYS)
    args = parser.parse_args(arguments)
    device = use_device(args.dev)
    dtype = compute_dtype(args.precision) or torch.float32

    mngr = CheckpointManager(
        args.checkpoint_dir, name=args.checkpoint_name or "segmentation",
        fold=0,
    )
    metadata = mngr.load_metadata()
    net_cfg = metadata.get("network_config", {})
    t_args = metadata.get("transform_arguments", {})
    n_classes = metadata.get("n_classes", args.n_classes)
    net_type = metadata.get("net_type", args.segmentation_net_type)
    image_keys = args.image_keys or t_args.get("image_keys", ["image"])
    label_keys = args.mask_keys or t_args.get("label_keys", ["label"])
    if int(net_cfg.get("spatial_dimensions", 3)) != 3:
        raise NotImplementedError("2D checkpoints are not ported yet")
    if t_args.get("skip_keys") or t_args.get("feature_keys"):
        raise NotImplementedError(
            "conditioned checkpoints (skip/feature keys) are not ported yet"
        )
    size = tuple(t_args.get("target_size"))

    model = get_segmentation_network(
        net_type, net_cfg, n_classes=n_classes, image_size=size
    )
    model.load_state_dict(mngr.load_state_dict())
    model = statistics_to_f32(model.to(device=device, dtype=dtype)).eval()

    load_fn = SegmentationTransforms(
        image_keys=image_keys,
        label_keys=label_keys,
        target_spacing=t_args.get("target_spacing"),
        target_size=size,
        resize_size=t_args.get("resize_size"),
        # the training run's intensity and label semantics
        adc_keys=t_args.get("adc_keys") or (),
        positive_labels=t_args.get("positive_labels") or (1,),
    ).load_fn()

    data = Dataset(args.dataset_json)
    pids = args.test_ids or list(data.keys())
    dices, ious, preds, labels = [], [], [], []
    for pid in pids:
        if pid not in data.dataset:
            continue
        sample = load_fn({**data[pid], "identifier": pid})
        x = torch.from_numpy(sample["image"]).to(device=device, dtype=dtype)
        with torch.inference_mode():
            prob_full = model(x[None], heads=False)[0].float().cpu().numpy()
        lab = sample["label"]
        dice, iou, prob = case_metrics(prob_full, lab, n_classes)
        dices.append(dice)
        ious.append(iou)
        if args.picai_eval:
            preds.append(prob)
            labels.append((lab > 0).astype(np.float32))
    results = {
        "dice": float(np.mean(dices)),
        "iou": float(np.mean(ious)),
        "n_cases": len(dices),
    }
    if args.picai_eval and preds:
        m = picai_evaluate(
            preds, labels, y_det_postprocess_func=lambda y: y > 0.1
        )
        results.update({"AP": m.AP, "auroc": m.auroc, "score": m.score})
    MetricLogger(csv_path=args.metric_path).log_metrics(results, step=0)
    print(json.dumps(results))
