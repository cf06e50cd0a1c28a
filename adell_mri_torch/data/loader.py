"""
Host-side data feeding: cached preprocessed volumes, batches prepared
ahead on a thread.

The port's own copy of ``CachedVolumeDataset``, ``DataLoader`` and
``safe_collate`` from ``adell_mri_tpu/data/loader.py`` and
``adell_mri_tpu/data/collate.py``. Batches are numpy; the train loop moves
them to the card. With ``cache_dir`` each loaded sample is also kept in
an ``.npz`` file keyed by its entry and the transform's fingerprint, so a
later run reads it instead of loading it again.
"""

import hashlib
import logging
import os
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
    load is logged and dropped (``None``), as the collate expects.

    ``cache_dir`` adds the disk cache: a file per sample named by a hash
    of the entry and ``cache_fingerprint`` (the entry point passes the
    transform's ``repr``, so that another spacing or size never reads a
    stale file), written atomically; a file that does not read is
    removed and loaded again. ``disk_reads`` and ``disk_writes`` count the
    files read and written."""

    def __init__(
        self,
        datalist: List[Dict[str, Any]],
        load_fn: Callable[[Dict[str, Any]], Dict[str, Any]],
        cache_rate: float = 1.0,
        cache_dir: Optional[str] = None,
        cache_fingerprint: str = "",
    ):
        self.datalist = datalist
        self.load_fn = load_fn
        self.cache_rate = cache_rate
        self.cache_dir = cache_dir
        self.cache_fingerprint = cache_fingerprint
        self.disk_reads = self.disk_writes = 0
        self._ram: Dict[int, Dict[str, Any]] = {}
        if cache_dir is not None:
            os.makedirs(cache_dir, exist_ok=True)

    def disk_path(self, entry: Dict[str, Any]) -> str:
        key = hashlib.sha1(
            (repr(sorted(entry.items())) + self.cache_fingerprint).encode()
        ).hexdigest()[:20]
        return os.path.join(self.cache_dir, key + ".npz")

    def __len__(self) -> int:
        return len(self.datalist)

    def _read_disk(self, path: str) -> Optional[Dict[str, Any]]:
        if not os.path.exists(path):
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                # 0-d arrays back to scalars (n_fg, the identifier)
                sample = {k: z[k][()] if z[k].ndim == 0 else z[k]
                          for k in z.files}
        except (OSError, ValueError, EOFError) as e:
            # a process killed mid-write leaves a truncated file
            logger.warning("corrupt cache %s (%s); loading again", path, e)
            try:
                os.remove(path)
            except OSError:
                pass
            return None
        self.disk_reads += 1
        return sample

    def _write_disk(self, path: str, sample: Dict[str, Any]):
        # a temporary file object (a str path would get ".npz" appended),
        # then a rename: a kill mid-save leaves no truncated cache file
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **sample)
            os.replace(tmp, path)
            self.disk_writes += 1
        except OSError as e:
            logger.warning("cache write failed %s: %s", path, e)
            try:
                os.remove(tmp)
            except OSError:
                pass

    def __getitem__(self, i: int) -> Optional[Dict[str, Any]]:
        if i in self._ram:
            return self._ram[i]
        entry = self.datalist[i]
        path = None if self.cache_dir is None else self.disk_path(entry)
        sample = None if path is None else self._read_disk(path)
        if sample is None:
            try:
                sample = self.load_fn(entry)
            except (OSError, ValueError, KeyError) as e:
                logger.warning(
                    "failed to load %s: %s", entry.get("identifier", i), e
                )
                return None
            if path is not None:
                self._write_disk(path, sample)
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
