"""
Metric logging to CSV.

The port's own copy of ``CSVLogger`` and the CSV half of ``MetricLogger``
from ``adell_mri_tpu/train/logging_utils.py``: one row per metric, with
its step, time and tags, appended to ``--metric_path``. wandb and MLflow
are not ported.
"""

import csv
import logging
import os
import time
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


class CSVLogger:
    """Accumulates rows and appends them to one CSV."""

    def __init__(self, path: str):
        self.path = path
        self.rows = []

    def log(self, **row: Any):
        self.rows.append(dict(row))

    def write(self):
        if not self.rows:
            return
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        keys = sorted({k for r in self.rows for k in r})
        exists = os.path.exists(self.path)
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            if not exists:
                w.writeheader()
            w.writerows(self.rows)
        self.rows = []


class MetricLogger:
    def __init__(self, csv_path: Optional[str] = None):
        self.csv = CSVLogger(csv_path) if csv_path else None

    def log_metrics(self, metrics: Dict[str, float], step: int = 0, **tags):
        metrics = {k: float(v) for k, v in metrics.items()}
        if self.csv is not None:
            for k, v in metrics.items():
                self.csv.log(metric=k, value=v, step=step, time=time.time(),
                             **tags)
            self.csv.write()
        logger.info(
            "step %d | %s", step,
            " ".join(f"{k}={v:.5g}" for k, v in metrics.items()),
        )
