"""
Evaluation of every validation epoch.

Counterpart of ``LesionEvalCallback`` and ``ClassificationMetricsCallback``
in ``adell_mri_tpu/eval/callbacks.py``. The lesion callback
(``--picai_eval``): a forward of its own over each validation batch keeps
the foreground probability maps on the host, and the epoch's end computes
the PI-CAI metrics over them (V_AP, V_AUC, V_score). The classification
callback: a forward of its own keeps each case's probabilities, and the
epoch's end computes ``binary_metrics`` or ``multiclass_metrics`` (V_*).
An ordinal network's cumulative-threshold logits become class
probabilities through ``ordinal_to_class_probs``.
"""

from typing import Callable, Dict, Optional

import numpy as np
import torch

from adell_mri_torch.eval.lesion import evaluate
from adell_mri_torch.eval.metrics import binary_metrics, multiclass_metrics
from adell_mri_torch.models.classification.losses import (
    ordinal_to_class_probs,
)
from adell_mri_torch.models.layers.adn import batch_statistics_mode


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


class ClassificationMetricsCallback:
    """``model`` runs in eval mode (no dropout) on each validation batch
    with the weights the loop validates, its batch norms normalizing by
    the batch's own statistics (``batch_statistics_mode``: (0, 1) where a
    feature has one element) and leaving the running averages alone, as
    the JAX callback's forward with the parameters alone does; at most
    ``max_cases`` cases are kept. ``feature_key``: the batch key of the
    model's second input (a ``HybridClassifier``'s tabular features).
    ``ordinal``: the model emits ``n_classes - 1`` cumulative-threshold
    logits (OrdNet), whose class probabilities take the multiclass
    metrics, two classes too. ``on_validation_end`` returns the finite
    metrics, ``V_``-prefixed."""

    def __init__(self, model, n_classes: int = 2, max_cases: int = 4096,
                 feature_key: Optional[str] = None, ordinal: bool = False):
        self.model = model
        self.n_classes = n_classes
        self.max_cases = max_cases
        self.feature_key = feature_key
        self.ordinal = ordinal
        self._probs = []
        self._labels = []

    def on_validation_batch(self, params, batch: Dict, metrics: Dict):
        if len(self._probs) >= self.max_cases:
            return
        self.model.eval()
        inputs = (batch["image"],)
        if self.feature_key and self.feature_key in batch:
            inputs += (batch[self.feature_key],)
        with torch.no_grad(), batch_statistics_mode(self.model):
            logits = torch.func.functional_call(self.model, params,
                                                inputs).float()
        if self.ordinal:
            probs = ordinal_to_class_probs(logits)
        elif self.n_classes > 2:
            probs = torch.softmax(logits, -1)
        else:
            probs = torch.sigmoid(logits[..., 0])
        probs = probs.cpu().numpy()
        labels = batch["label"].float().cpu().numpy().reshape(-1)
        for i in range(probs.shape[0]):
            if len(self._probs) >= self.max_cases:
                break
            self._probs.append(probs[i])
            self._labels.append(labels[i])

    def on_validation_end(self, params) -> Optional[Dict[str, float]]:
        if not self._probs:
            return None
        probs, labels = np.stack(self._probs), np.asarray(self._labels)
        self._probs, self._labels = [], []
        m = (multiclass_metrics(probs, labels)
             if self.n_classes > 2 or self.ordinal
             else binary_metrics(probs, labels))
        return {f"V_{k}": float(v) for k, v in m.items()
                if np.isfinite(v)} or None
