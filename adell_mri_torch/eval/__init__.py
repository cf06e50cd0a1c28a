"""Evaluation of the port: voxel metrics and lesion-level PI-CAI metrics."""

from adell_mri_torch.eval.lesion import (
    Metrics,
    evaluate,
    evaluate_case,
    extract_lesion_candidates,
)
from adell_mri_torch.eval.metrics import (
    auc_score,
    binary_metrics,
    dice_score,
    expected_calibration_error,
    iou_score,
    multiclass_metrics,
    segmentation_class_metrics,
)

__all__ = [
    "Metrics",
    "auc_score",
    "binary_metrics",
    "dice_score",
    "evaluate",
    "evaluate_case",
    "expected_calibration_error",
    "extract_lesion_candidates",
    "iou_score",
    "multiclass_metrics",
    "segmentation_class_metrics",
]
