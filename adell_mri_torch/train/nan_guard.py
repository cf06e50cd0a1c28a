"""
NaN-loss forensics.

Counterpart of ``adell_mri_tpu/train/nan_guard.py``: opt-in, because the
finiteness check reads a device scalar and so waits for the card.
"""

import logging
import os
import time
from typing import Dict

import numpy as np
import torch

logger = logging.getLogger(__name__)


class NaNGuard:
    """Checks the running loss sum for non-finite values (the loop calls
    ``check`` every ``every`` steps); on one, writes the batch and the
    first 64 parameters' absolute maxima to an ``.npz`` in ``dump_dir``
    and raises ``FloatingPointError``. The running sum catches a NaN
    anywhere in the epoch at the next check; the batch dumped is the one
    in flight then (``every=1`` makes it the offender)."""

    def __init__(self, dump_dir: str = ".", every: int = 1):
        self.dump_dir = dump_dir
        self.every = max(1, int(every))

    def check(self, metric_sums: Dict, state, batch: Dict, epoch: int,
              step: int):
        loss = metric_sums.get("loss")
        if loss is None or np.isfinite(float(loss)):
            return
        os.makedirs(self.dump_dir, exist_ok=True)
        path = os.path.join(
            self.dump_dir, f"nan_dump_e{epoch}_s{step}_{int(time.time())}.npz"
        )
        arrays = {
            k: v.detach().float().cpu().numpy()
            if v.is_floating_point() else v.detach().cpu().numpy()
            for k, v in batch.items() if isinstance(v, torch.Tensor)
        }
        arrays["param_abs_max"] = np.asarray([
            float(p.detach().abs().max())
            for p in list(state.params.values())[:64]
        ])
        np.savez_compressed(path, **arrays)
        logger.error("non-finite loss at epoch %d step %d; batch dumped to %s",
                     epoch, step, path)
        raise FloatingPointError(
            f"non-finite training loss at epoch {epoch} step {step}; "
            f"forensic dump written to {path}"
        )
