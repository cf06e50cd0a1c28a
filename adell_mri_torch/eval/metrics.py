"""
Scalar evaluation metrics, in numpy.

The port's own copy of ``adell_mri_tpu/eval/metrics.py`` (``dice_score``,
``iou_score``, ``auc_score``, ``expected_calibration_error``,
``binary_metrics``, ``multiclass_metrics``,
``segmentation_class_metrics``). The JAX package takes precision, recall,
F1 and the ROC AUC from scikit-learn; the port computes the same
quantities here in numpy, with scikit-learn's conventions: zero for an
empty denominator (``zero_division=0``), macro averages over the labels
present in the target or the prediction, and NaN for an AUC whose target
holds one class.
"""

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def dice_score(pred: np.ndarray, target: np.ndarray,
               threshold: float = 0.5) -> float:
    p = np.asarray(pred) > threshold
    t = np.asarray(target) > 0.5
    denom = p.sum() + t.sum()
    if denom == 0:
        return 1.0
    return float(2 * np.logical_and(p, t).sum() / denom)


def iou_score(pred: np.ndarray, target: np.ndarray,
              threshold: float = 0.5) -> float:
    p = np.asarray(pred) > threshold
    t = np.asarray(target) > 0.5
    union = np.logical_or(p, t).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(p, t).sum() / union)


def counts_at_thresholds(
    target: np.ndarray, score: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """False and true positives at each distinct score, highest first
    (scikit-learn's ``confusion_matrix_at_thresholds``): ``(fps, tps,
    thresholds)``."""
    target = np.asarray(target).reshape(-1) == 1
    score = np.asarray(score).reshape(-1)
    order = np.argsort(score, kind="mergesort")[::-1]
    score = score[order]
    target = target[order]
    distinct = np.where(np.diff(score))[0]
    idx = np.r_[distinct, target.size - 1]
    tps = np.cumsum(target, dtype=np.float64)[idx]
    fps = 1 + idx - tps
    return fps, tps, score[idx]


def precision_recall_curve(
    target: np.ndarray, score: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """scikit-learn's ``precision_recall_curve`` (every threshold kept):
    precision and recall with a final (1, 0) point, recall decreasing."""
    fps, tps, thresholds = counts_at_thresholds(target, score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return (np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0],
            thresholds[::-1])


def roc_auc(target: np.ndarray, score: np.ndarray) -> float:
    """Area under the ROC curve by the trapezoid rule; NaN when the
    target holds one class."""
    target = np.asarray(target).reshape(-1)
    if len(np.unique(target)) != 2:
        return float("nan")
    fps, tps, _ = counts_at_thresholds(target, score)
    fpr = np.r_[0.0, fps / fps[-1]]
    tpr = np.r_[0.0, tps / tps[-1]]
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2))


def auc_score(pred: np.ndarray, target: np.ndarray) -> float:
    target = np.asarray(target)
    if len(np.unique(target)) < 2:
        return float("nan")
    return roc_auc(target, np.asarray(pred))


def expected_calibration_error(
    pred: np.ndarray, target: np.ndarray, n_bins: int = 10
) -> float:
    pred = np.asarray(pred, np.float64)
    target = np.asarray(target, np.float64)
    bins = np.linspace(0, 1, n_bins + 1)
    ece = 0.0
    for i, (lo, hi) in enumerate(zip(bins[:-1], bins[1:])):
        # the top bin closes at 1.0, so saturated predictions count
        mask = (
            (pred >= lo) & (pred <= hi)
            if i == n_bins - 1
            else (pred >= lo) & (pred < hi)
        )
        if mask.sum() == 0:
            continue
        conf = pred[mask].mean()
        acc = target[mask].mean()
        ece += mask.mean() * abs(conf - acc)
    return float(ece)


def _divide(num, den):
    num = np.asarray(num, np.float64)
    den = np.asarray(den, np.float64)
    return np.divide(num, den, out=np.zeros_like(num), where=den != 0)


def precision_recall_f1(
    target: np.ndarray, hard: np.ndarray,
    labels: Optional[Sequence[int]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-label precision, recall and F1 (``2 tp / (2 tp + fp + fn)``),
    zero where a denominator is zero. ``labels`` defaults to those
    present in ``target`` or ``hard``."""
    target = np.asarray(target).reshape(-1)
    hard = np.asarray(hard).reshape(-1)
    if labels is None:
        labels = np.union1d(target, hard)
    labels = np.asarray(labels)
    t = target[None] == labels[:, None]
    h = hard[None] == labels[:, None]
    tp = (t & h).sum(1)
    fp = (~t & h).sum(1)
    fn = (t & ~h).sum(1)
    return (_divide(tp, tp + fp), _divide(tp, tp + fn),
            _divide(2 * tp, 2 * tp + fp + fn))


def binary_metrics(
    pred: np.ndarray, target: np.ndarray, threshold: float = 0.5
) -> Dict[str, float]:
    """Accuracy, precision, recall, specificity, F1, AUC and calibration
    error of binary predictions (positive label 1)."""
    pred = np.asarray(pred)
    target = np.asarray(target).astype(int)
    hard = (pred > threshold).astype(int)
    tn = int(np.sum((hard == 0) & (target == 0)))
    fp = int(np.sum((hard == 1) & (target == 0)))
    precision, recall, f1 = (float(v[0]) for v in
                             precision_recall_f1(target, hard, labels=[1]))
    return {
        "accuracy": float((hard == target).mean()),
        "precision": precision,
        "recall": recall,
        "specificity": float(tn / max(tn + fp, 1)),
        "f1": f1,
        "auc": auc_score(pred, target),
        "ece": expected_calibration_error(pred, target),
    }


def multiclass_metrics(probs: np.ndarray,
                       target: np.ndarray) -> Dict[str, float]:
    """Macro precision, recall, F1 and specificity, one-vs-rest AUROC and
    the top-label calibration error of ``probs`` [N, C] against ``target``
    [N], with per-class precision, recall and F1 (``*_c{k}``)."""
    probs = np.asarray(probs, np.float64)
    target = np.asarray(target).astype(int).reshape(-1)
    nc = probs.shape[-1]
    hard = probs.argmax(-1)
    p, r, f = precision_recall_f1(target, hard)
    out = {
        "accuracy": float((hard == target).mean()),
        "precision": float(p.mean()),
        "recall": float(r.mean()),
        "f1": float(f.mean()),
    }
    specs = []
    for k in range(nc):
        tn = np.sum((hard != k) & (target != k))
        fp = np.sum((hard == k) & (target != k))
        specs.append(tn / max(tn + fp, 1))
    out["specificity"] = float(np.mean(specs))
    if len(np.unique(target)) > 1 and not np.setdiff1d(target,
                                                       np.arange(nc)).size:
        scores = probs / np.maximum(probs.sum(-1, keepdims=True), 1e-12)
        out["auc"] = float(np.mean([
            roc_auc((target == k).astype(int), scores[:, k])
            for k in range(nc)
        ]))
    else:
        out["auc"] = float("nan")
    conf = probs.max(-1)
    correct = (hard == target).astype(np.float64)
    out["ece"] = expected_calibration_error(conf, correct)
    p, r, f = precision_recall_f1(target, hard, labels=np.arange(nc))
    for k in range(nc):
        out[f"precision_c{k}"] = float(p[k])
        out[f"recall_c{k}"] = float(r[k])
        out[f"f1_c{k}"] = float(f[k])
    return out


def segmentation_class_metrics(
    pred: np.ndarray, target: np.ndarray, n_classes: int
) -> Dict[str, float]:
    """Per-class and macro Dice and IoU of multiclass label maps, the
    background (class 0) left out."""
    pred = np.asarray(pred)
    target = np.asarray(target)
    out: Dict[str, float] = {}
    dices, ious = [], []
    for k in range(1, n_classes):
        p = pred == k
        t = target == k
        denom = p.sum() + t.sum()
        inter = np.logical_and(p, t).sum()
        union = np.logical_or(p, t).sum()
        d = 1.0 if denom == 0 else float(2 * inter / denom)
        i = 1.0 if union == 0 else float(inter / union)
        out[f"dice_c{k}"] = d
        out[f"iou_c{k}"] = i
        dices.append(d)
        ious.append(i)
    out["dice_macro"] = float(np.mean(dices)) if dices else float("nan")
    out["iou_macro"] = float(np.mean(ious)) if ious else float("nan")
    return out
