"""
The training loop.

Counterpart of ``TrainLoop`` in ``adell_mri_tpu/train/loop.py``: epochs
over a DataLoader, batches moved to the card and augmented there, the
train step, validation every ``check_val_every_n_epoch`` epochs, the
epoch's metrics to the metric logger, and an end-of-epoch checkpoint save
through the monitored metric. Early
stopping, callbacks, the NaN guard and the profiler window are not ported
yet.
"""

import itertools
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch


class TrainLoop:
    def __init__(
        self,
        train_step: Callable,  # (state, batch) -> (state, metrics)
        eval_step: Optional[Callable] = None,  # (params, batch) -> metrics
        augment_fn: Optional[Callable] = None,  # (generator, batch) -> batch
        device=None,
        max_epochs: int = 100,
        check_val_every_n_epoch: int = 1,
        monitor: str = "val_loss",
        ckpt_manager=None,
        metric_logger=None,
        seed: int = 42,
        steps_per_epoch: Optional[int] = None,
    ):
        self.train_step = train_step
        self.eval_step = eval_step
        self.augment_fn = augment_fn
        self.device = torch.device(device or "cpu")
        self.max_epochs = max_epochs
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.monitor = monitor
        self.ckpt_manager = ckpt_manager
        self.metric_logger = metric_logger
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # cap on train batches per epoch (Lightning limit_train_batches)
        self.steps_per_epoch = steps_per_epoch

    def _put(self, batch: Dict) -> Dict:
        return {
            k: torch.from_numpy(v).to(self.device, non_blocking=True)
            for k, v in batch.items()
            if isinstance(v, np.ndarray)
        }

    def _epoch(self, state, loader):
        # metrics stay device scalars until the epoch ends: reading one per
        # step would make the host wait for the card every step
        sums: Dict[str, torch.Tensor] = {}
        n = n_samples = 0
        t0 = time.perf_counter()
        # cap before fetching, so no batch is loaded and dropped
        batches = (
            itertools.islice(loader, self.steps_per_epoch)
            if self.steps_per_epoch is not None else loader
        )
        for batch in batches:
            batch = self._put(batch)
            n_samples += batch["image"].shape[0]
            if self.augment_fn is not None:
                batch = self.augment_fn(self.generator, batch)
            state, metrics = self.train_step(state, batch)
            n += 1
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
        out = {k: float(v) / max(n, 1) for k, v in sums.items()}
        dt = time.perf_counter() - t0
        out["samples_per_sec"] = n_samples / dt if dt > 0 else 0.0
        return state, out

    def _validate(self, state, loader):
        sums: Dict[str, torch.Tensor] = {}
        n_samples = 0
        for batch in loader:
            batch = self._put(batch)
            metrics = self.eval_step(state.params, batch)
            # a partial last batch weighs by its size
            bs = batch["image"].shape[0]
            n_samples += bs
            for k, v in metrics.items():
                sums[k] = sums[k] + v * bs if k in sums else v * bs
        return {
            f"val_{k}": float(v) / max(n_samples, 1) for k, v in sums.items()
        }

    def fit(self, state, train_loader, val_loader=None):
        history = []
        for epoch in range(self.max_epochs):
            state, metrics = self._epoch(state, train_loader)
            if (
                val_loader is not None
                and self.eval_step is not None
                and (epoch + 1) % self.check_val_every_n_epoch == 0
            ):
                metrics.update(self._validate(state, val_loader))
            history.append(metrics)
            if self.metric_logger is not None:
                self.metric_logger.log_metrics(metrics, step=epoch)
            if self.ckpt_manager is not None:
                self.ckpt_manager.save_epoch(
                    epoch + 1, state.state_dict(), metrics
                )
        return state, history
