"""
Host-side data feeding: cached preprocessed volumes, batches prepared
ahead on a thread.

The port's own copy of ``CachedVolumeDataset``, ``DataLoader`` and
``safe_collate`` from ``adell_mri_tpu/data/loader.py`` and
``adell_mri_tpu/data/collate.py``. Batches are numpy; the train loop moves
them to the card. The ``.npz`` disk cache (``--cache_dir``) is not ported
yet.
"""

import logging
import queue
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def _stack_values(values: List[Any]):
    first = values[0]
    if isinstance(first, np.ndarray):
        return np.stack(values, axis=0)
    if isinstance(first, (int, float, np.integer, np.floating)):
        return np.asarray(values)
    return values  # strings / identifiers stay as lists


def safe_collate(batch: List[Optional[Dict[str, Any]]]) -> Dict[str, Any]:
    """Drops None samples, then stacks each key across the batch."""
    batch = [b for b in batch if b is not None]
    if not batch:
        return {}
    return {k: _stack_values([b[k] for b in batch]) for k in batch[0]}


class CachedVolumeDataset:
    """Applies the deterministic ``load_fn`` lazily and keeps the first
    ``cache_rate`` share of the samples in RAM. A sample that fails to
    load is logged and dropped (``None``), as the collate expects."""

    def __init__(
        self,
        datalist: List[Dict[str, Any]],
        load_fn: Callable[[Dict[str, Any]], Dict[str, Any]],
        cache_rate: float = 1.0,
    ):
        self.datalist = datalist
        self.load_fn = load_fn
        self.cache_rate = cache_rate
        self._ram: Dict[int, Dict[str, Any]] = {}

    def __len__(self) -> int:
        return len(self.datalist)

    def __getitem__(self, i: int) -> Optional[Dict[str, Any]]:
        if i in self._ram:
            return self._ram[i]
        entry = self.datalist[i]
        try:
            sample = self.load_fn(entry)
        except (OSError, ValueError, KeyError) as e:
            logger.warning(
                "failed to load %s: %s", entry.get("identifier", i), e
            )
            return None
        if self.cache_rate >= 1.0 or i / max(1, len(self)) < self.cache_rate:
            self._ram[i] = sample
        return sample


class DataLoader:
    """Fixed-shape numpy batches from ``sampler``'s indices, ``prefetch``
    batches prepared ahead by a worker thread."""

    def __init__(
        self,
        dataset,
        sampler: Iterable[int] = None,
        batch_size: int = 1,
        drop_last: bool = True,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.dataset) if self.sampler is None else len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self, indices: Sequence[int]):
        for start in range(0, len(indices), self.batch_size):
            chunk = indices[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            batch = safe_collate([self.dataset[i] for i in chunk])
            if batch:
                yield batch

    def __iter__(self):
        indices = (
            list(range(len(self.dataset))) if self.sampler is None
            else list(self.sampler)
        )
        if self.prefetch <= 0:
            yield from self._batches(indices)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            # a timed put, so a consumer that stops early cannot leave the
            # worker blocked
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self._batches(indices):
                    if not put(batch):
                        return
                put(sentinel)
            except BaseException as exc:  # handed to the consumer, re-raised
                put(exc)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)
