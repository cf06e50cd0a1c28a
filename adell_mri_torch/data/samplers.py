"""
Index samplers of the train loop.

The port's own copy of ``RandomSampler`` from
``adell_mri_tpu/data/samplers.py``.
"""

from typing import Iterator

import numpy as np


class RandomSampler:
    """A shuffled pass over ``n`` indices. ``set_n_samples`` pins the epoch
    length, drawing with replacement when it exceeds ``n``."""

    def __init__(self, n: int, seed: int = 42):
        self.n = n
        self.n_samples = None
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
