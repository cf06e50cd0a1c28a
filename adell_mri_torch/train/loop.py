"""
The training loop.

Counterpart of ``TrainLoop`` in ``adell_mri_tpu/train/loop.py``: epochs
over a DataLoader, batches moved to the card and augmented there, the
train step, validation every ``check_val_every_n_epoch`` epochs (on the
EMA/SWA shadow with ``eval_on_ema``), callbacks (``on_validation_batch``,
``on_validation_end``, whose metrics join the epoch's, and
``on_epoch_end``, which may return ``"stop"``), the epoch's metrics to the
metric logger, an end-of-epoch save of the best weights through the
monitored metric and of the last state (for resume), early stopping on
the monitored metric with ``mode``, the opt-in NaN guard, and
``start_epoch`` to continue a resumed run. The profiler window is not
ported.
"""

import itertools
import logging
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


class TrainLoop:
    def __init__(
        self,
        train_step: Callable,  # (state, batch) -> (state, metrics)
        eval_step: Optional[Callable] = None,  # (params, batch) -> metrics
        augment_fn: Optional[Callable] = None,  # (generator, batch) -> batch
        device=None,
        max_epochs: int = 100,
        check_val_every_n_epoch: int = 1,
        early_stopping: Optional[int] = None,
        monitor: str = "val_loss",
        mode: str = "min",
        ckpt_manager=None,
        metric_logger=None,
        seed: int = 42,
        eval_on_ema: bool = False,
        callbacks=(),
        nan_guard=None,
        steps_per_epoch: Optional[int] = None,
    ):
        self.train_step = train_step
        self.eval_step = eval_step
        self.augment_fn = augment_fn
        self.device = torch.device(device or "cpu")
        self.max_epochs = max_epochs
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.early_stopping = early_stopping
        self.monitor = monitor
        self.mode = mode
        self.ckpt_manager = ckpt_manager
        self.metric_logger = metric_logger
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.eval_on_ema = eval_on_ema
        self.callbacks = list(callbacks)
        self.nan_guard = nan_guard
        # cap on train batches per epoch (Lightning limit_train_batches)
        self.steps_per_epoch = steps_per_epoch

    def _put(self, batch: Dict) -> Dict:
        return {
            k: torch.from_numpy(v).to(self.device, non_blocking=True)
            for k, v in batch.items()
            if isinstance(v, np.ndarray)
        }

    def _epoch(self, state, loader, epoch: int = 0):
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
        guard = self.nan_guard
        for batch in batches:
            batch = self._put(batch)
            n_samples += batch["image"].shape[0]
            if self.augment_fn is not None:
                batch = self.augment_fn(self.generator, batch)
            state, metrics = self.train_step(state, batch)
            n += 1
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
            if guard is not None and n % guard.every == 0:
                guard.check(sums, state, batch, epoch, n)
        out = {k: float(v) / max(n, 1) for k, v in sums.items()}
        dt = time.perf_counter() - t0
        out["samples_per_sec"] = n_samples / dt if dt > 0 else 0.0
        return state, out

    def _validate(self, state, loader):
        params = (
            state.ema_params
            if self.eval_on_ema and state.ema_params is not None
            else state.params
        )
        # the shadow averages the parameters only: the running statistics
        # are the state's in either case, as in the JAX loop
        params = {**params, **getattr(state, "variables", {})}
        sums: Dict[str, torch.Tensor] = {}
        n_samples = 0
        for batch in loader:
            batch = self._put(batch)
            metrics = self.eval_step(params, batch)
            # a partial last batch weighs by its size
            bs = batch["image"].shape[0]
            n_samples += bs
            for k, v in metrics.items():
                sums[k] = sums[k] + v * bs if k in sums else v * bs
            for cb in self.callbacks:
                hook = getattr(cb, "on_validation_batch", None)
                if hook is not None:
                    hook(params, batch, metrics)
        out = {
            f"val_{k}": float(v) / max(n_samples, 1) for k, v in sums.items()
        }
        for cb in self.callbacks:
            hook = getattr(cb, "on_validation_end", None)
            if hook is not None:
                out.update(hook(params) or {})
        return out

    def _improved(self, value: float, best: Optional[float]) -> bool:
        if best is None:
            return True
        return value < best if self.mode == "min" else value > best

    def fit(self, state, train_loader, val_loader=None,
            start_epoch: int = 0):
        """``start_epoch`` continues a resumed run: the epoch the restored
        state had finished, so that epoch numbers, checkpoint steps and
        the schedule go on from there."""
        best = None
        patience = 0
        history = []
        for epoch in range(start_epoch, self.max_epochs):
            state, metrics = self._epoch(state, train_loader, epoch)
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
                self.ckpt_manager.save_last(state, epoch + 1)
            stop = False
            for cb in self.callbacks:
                hook = getattr(cb, "on_epoch_end", None)
                if hook is not None and hook(state, metrics, epoch) == "stop":
                    stop = True
            if stop:
                break
            if self.early_stopping and self.monitor in metrics:
                value = metrics[self.monitor]
                if self._improved(value, best):
                    best, patience = value, 0
                else:
                    patience += 1
                    if patience >= self.early_stopping:
                        logger.info("early stopping at epoch %d (%s=%.5g)",
                                    epoch, self.monitor, best)
                        break
        return state, history
