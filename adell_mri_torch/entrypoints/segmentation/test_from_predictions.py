"""
``python -m adell_mri_torch segmentation test_from_predictions``.

Counterpart of ``adell_mri_tpu/entrypoints/segmentation/
test_from_predictions.py``: voxel metrics (``binary_metrics``, Dice and
IoU) of prediction volumes already written (NIfTI, ``.npy`` or ``.npz``)
against their ground truth, per case and averaged, and with
``--picai_eval`` the lesion-level AP, AUROC and score over lesion
candidates extracted from them. Masks, probabilities or logits; a class
axis (multiclass) or an ensemble axis first. numpy and scipy only: no
device is used.
"""

import json

import numpy as np

from adell_mri_torch.data import Dataset, read_nifti, reorient_to_ras
from adell_mri_torch.entrypoints.assemble_args import Parser
from adell_mri_torch.eval.lesion import evaluate, extract_lesion_candidates
from adell_mri_torch.eval.metrics import binary_metrics, dice_score, iou_score


def _read_any(path: str) -> np.ndarray:
    if path.endswith((".npy", ".npz")):
        arr = np.load(path)
        if hasattr(arr, "files"):
            arr = arr[arr.files[0]]
        return np.asarray(arr, np.float32)
    return reorient_to_ras(read_nifti(path)).data.astype(np.float32)


def _softmax(x, axis):
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def main(arguments):
    parser = Parser(prog="adell segmentation test_from_predictions")
    parser.add_argument_by_key(
        ["dataset_json", "n_classes", ("mask_keys", "ground_truth_key", {})]
    )
    parser.add_argument(
        "--prediction_key", required=True,
        help="dataset key holding the prediction path",
    )
    parser.add_argument(
        "--prediction_mode", default="mask",
        choices=["mask", "probs", "logits"],
    )
    parser.add_argument(
        "--reduction", default="mean",
        help="ensemble reduction when predictions are 4D: mean|max|<index>",
    )
    parser.add_argument("--proba_threshold", type=float, default=0.5)
    parser.add_argument("--picai_eval", action="store_true")
    parser.add_argument("--min_size", type=float, default=10.0)
    parser.add_argument("--output_json", default=None)
    args = parser.parse_args(arguments)

    gt_key = (
        args.ground_truth_key[0]
        if isinstance(args.ground_truth_key, list)
        else args.ground_truth_key
    )
    data = Dataset(args.dataset_json)
    pids = [p for p in data.keys()
            if args.prediction_key in data[p] and gt_key in data[p]]

    per_case = {}
    preds, gts = [], []
    for pid in pids:
        entry = data[pid]
        pred = _read_any(entry[args.prediction_key])
        gt = _read_any(entry[gt_key])
        # a leading extra axis is a class axis (n_classes of them, logits
        # or probabilities) before it is an ensemble axis
        is_class_axis = (
            args.n_classes > 2
            and pred.ndim == gt.ndim + 1
            and pred.shape[0] == args.n_classes
        )
        if is_class_axis:
            if args.prediction_mode == "logits":
                pred = _softmax(pred, axis=0)
            pred = 1.0 - pred[0]
        elif pred.ndim == gt.ndim + 1:
            if args.reduction == "mean":
                pred = pred.mean(0)
            elif args.reduction == "max":
                pred = pred.max(0)
            else:
                pred = pred[int(args.reduction)]
        if args.prediction_mode == "logits" and not is_class_axis:
            pred = 1.0 / (1.0 + np.exp(-pred))
        gt_bin = (gt > 0.5).astype(np.float32)
        m = binary_metrics(
            pred.ravel(), gt_bin.ravel(), threshold=args.proba_threshold
        )
        m["dice"] = dice_score(pred, gt_bin, threshold=args.proba_threshold)
        m["iou"] = iou_score(pred, gt_bin, threshold=args.proba_threshold)
        per_case[pid] = {k: float(v) for k, v in m.items()}
        preds.append(pred)
        gts.append(gt_bin)

    agg = {
        k: float(np.mean([c[k] for c in per_case.values()]))
        for k in next(iter(per_case.values()), {})
    }
    if args.picai_eval and preds:
        def get_lesions(pred):
            return extract_lesion_candidates(
                pred, min_voxels=int(args.min_size)
            )[0]

        metrics = evaluate(preds, gts, y_det_postprocess_func=get_lesions)
        agg.update({
            "lesion_AP": float(metrics.AP),
            "lesion_auroc": float(metrics.auroc),
            "lesion_score": float(metrics.score),
        })
    out = {"aggregate": agg, "cases": per_case}
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(agg))
