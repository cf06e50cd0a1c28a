"""
Conformal prediction with adaptive prediction sets.

The port's own copy of ``AdaptivePredictionSets`` in
``adell_mri_tpu/models/layers/conformal.py`` (numpy). ``calibrate`` takes
softmax probabilities [N, C] and integer labels [N] of held-out cases and
sets ``q_hat``: the ``ceil((N + 1)(1 - alpha)) / N`` quantile (numpy's
``method="higher"``, which keeps the finite-sample coverage of at least
``1 - alpha``; linear interpolation would give a smaller threshold) of
each case's cumulative probability, over the classes sorted by falling
probability, up to and including its true class. A prediction set holds
the classes, in that order, whose cumulative probability is at most
``q_hat``, and always the most probable one.
"""

from typing import Optional

import numpy as np


class AdaptivePredictionSets:
    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.q_hat: Optional[float] = None

    def calibrate(self, probs: np.ndarray, labels: np.ndarray):
        """``probs`` [N, C], ``labels`` [N] (int); returns ``self``."""
        probs = np.asarray(probs)
        labels = np.asarray(labels).astype(int)
        n = len(probs)
        order = np.argsort(-probs, axis=1)
        ranks = np.empty_like(order)
        ranks[np.arange(n)[:, None], order] = np.arange(probs.shape[1])[None]
        cumsum = np.cumsum(np.take_along_axis(probs, order, axis=1), axis=1)
        scores = cumsum[np.arange(n), ranks[np.arange(n), labels]]
        q_level = np.ceil((n + 1) * (1 - self.alpha)) / n
        self.q_hat = float(
            np.quantile(scores, min(q_level, 1.0), method="higher"))
        return self

    def __call__(self, probs: np.ndarray) -> np.ndarray:
        """The membership [N, C] (bool) of each row's prediction set."""
        if self.q_hat is None:
            raise RuntimeError("call calibrate() first")
        probs = np.asarray(probs)
        order = np.argsort(-probs, axis=1)
        cumsum = np.cumsum(np.take_along_axis(probs, order, axis=1), axis=1)
        include_sorted = cumsum <= self.q_hat
        include_sorted[:, 0] = True
        out = np.zeros_like(include_sorted)
        np.put_along_axis(out, order, include_sorted, axis=1)
        return out
