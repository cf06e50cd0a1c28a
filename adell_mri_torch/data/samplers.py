"""
Index samplers of the train loop.

The port's own copy of ``PartiallyRandomSampler``, ``WeightedSampler``,
``RandomSampler`` and ``class_weights_from_labels`` from
``adell_mri_tpu/data/samplers.py``: numpy generators seeded the same way,
so that the same seed gives the same index sequence.
"""

from typing import Iterator, List, Sequence

import numpy as np


class PartiallyRandomSampler:
    """Each epoch yields every index whose class is in ``keep_classes`` and
    a random ``non_keep_ratio`` share of the rest, shuffled together;
    ``set_n_samples`` pins the epoch length (the order tiled)."""

    def __init__(
        self,
        classes: Sequence,
        keep_classes: Sequence = (1,),
        non_keep_ratio: float = 1.0,
        seed: int = 42,
        shuffle: bool = True,
    ):
        keep_set = {str(k) for k in keep_classes}
        self.keep_list = [i for i, c in enumerate(classes)
                          if str(c) in keep_set]
        self.non_keep_list = [i for i, c in enumerate(classes)
                              if str(c) not in keep_set]
        self.non_keep_ratio = non_keep_ratio
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.n_samples = None

    def set_n_samples(self, n: int):
        self.n_samples = n

    def _epoch_indices(self) -> np.ndarray:
        n_non_keep = int(len(self.non_keep_list) * self.non_keep_ratio)
        sampled = (
            self.rng.choice(self.non_keep_list, size=n_non_keep,
                            replace=False)
            if n_non_keep > 0 else np.array([], dtype=np.int64)
        )
        idx = np.concatenate([np.asarray(self.keep_list, dtype=np.int64),
                              sampled.astype(np.int64)])
        if self.shuffle:
            self.rng.shuffle(idx)
        if self.n_samples is not None:
            reps = int(np.ceil(self.n_samples / max(1, len(idx))))
            idx = np.tile(idx, reps)[:self.n_samples]
        return idx

    def __iter__(self) -> Iterator[int]:
        yield from self._epoch_indices().tolist()

    def __len__(self) -> int:
        if self.n_samples is not None:
            return self.n_samples
        return len(self.keep_list) + int(
            len(self.non_keep_list) * self.non_keep_ratio)


class WeightedSampler:
    """``n_samples`` indices an epoch (one a weight by default), drawn with
    replacement in proportion to ``weights``."""

    def __init__(self, weights: Sequence[float], n_samples: int = None,
                 seed: int = 42):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.weights = self.weights / self.weights.sum()
        self.n_samples = n_samples or len(self.weights)
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[int]:
        yield from self.rng.choice(
            len(self.weights), size=self.n_samples, p=self.weights
        ).tolist()

    def __len__(self) -> int:
        return self.n_samples


def class_weights_from_labels(labels: List) -> np.ndarray:
    """Inverse-frequency weights, one a sample: ``n / (n_classes *
    count(label))``, labels compared as strings."""
    labels = [str(x) for x in labels]
    uniq, counts = np.unique(labels, return_counts=True)
    freq = dict(zip(uniq.tolist(), counts.tolist()))
    n = len(labels)
    return np.asarray([n / (len(uniq) * freq[x]) for x in labels])


class RandomSampler:
    """A shuffled pass over ``n`` indices. ``n_samples`` (or
    ``set_n_samples``) pins the epoch length, drawing with replacement
    when it exceeds ``n``."""

    def __init__(self, n: int, seed: int = 42, n_samples: int = None):
        self.n = n
        self.n_samples = n_samples
        self.rng = np.random.default_rng(seed)

    def set_n_samples(self, n: int):
        self.n_samples = n

    def __iter__(self) -> Iterator[int]:
        if self.n_samples is not None and self.n_samples != self.n:
            yield from self.rng.choice(
                self.n, size=self.n_samples, replace=self.n_samples > self.n
            ).tolist()
            return
        idx = np.arange(self.n)
        self.rng.shuffle(idx)
        yield from idx.tolist()

    def __len__(self) -> int:
        return self.n_samples if self.n_samples is not None else self.n
