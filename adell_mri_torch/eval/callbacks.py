"""
Lesion evaluation of every validation epoch.

Counterpart of ``LesionEvalCallback`` in ``adell_mri_tpu/eval/callbacks.py``
(``--picai_eval``): a forward of its own over each validation batch keeps
the foreground probability maps on the host, and the epoch's end computes
the PI-CAI metrics over them (V_AP, V_AUC, V_score).
"""

from typing import Callable, Dict, Optional

import numpy as np
import torch

from adell_mri_torch.eval.lesion import evaluate


def foreground_probability(pred: torch.Tensor) -> torch.Tensor:
    """The foreground probability of a model output [B, *S, C]: the one
    sigmoid channel of a binary model, else 1 - P(background)."""
    if pred.shape[-1] == 1:
        return pred[..., 0]
    return 1.0 - pred[..., 0]


class LesionEvalCallback:
    """``forward(params, image) -> probabilities [B, *S, C]`` runs on each
    validation batch (at most ``max_cases`` cases are kept);
    ``on_validation_end`` returns the finite ones of V_AP, V_AUC and
    V_score, the validation postprocess being the binary map ``y > 0.1``."""

    def __init__(
        self,
        forward: Callable,
        max_cases: int = 128,
        min_overlap: float = 0.10,
        num_parallel_calls: int = 4,
    ):
        self.forward = forward
        self.max_cases = max_cases
        self.min_overlap = min_overlap
        self.num_parallel_calls = num_parallel_calls
        self._preds = []
        self._labels = []

    def on_validation_batch(self, params, batch: Dict, metrics: Dict):
        if len(self._preds) >= self.max_cases:
            return
        with torch.no_grad():
            pred = foreground_probability(self.forward(params, batch["image"]))
        pred = pred.float().cpu().numpy()
        label = batch["label"].float().cpu().numpy()
        if label.ndim == pred.ndim + 1:
            label = label[..., 0]
        for i in range(pred.shape[0]):
            if len(self._preds) >= self.max_cases:
                break
            self._preds.append(pred[i])
            self._labels.append(label[i])

    def on_validation_end(self, params) -> Optional[Dict[str, float]]:
        if not self._preds:
            return None
        m = evaluate(
            self._preds,
            self._labels,
            min_overlap=self.min_overlap,
            num_parallel_calls=self.num_parallel_calls,
            y_det_postprocess_func=lambda y: y > 0.1,
        )
        self._preds, self._labels = [], []
        out = {"V_AP": m.AP, "V_AUC": m.auroc, "V_score": m.score}
        return {k: float(v) for k, v in out.items() if np.isfinite(v)} or None
