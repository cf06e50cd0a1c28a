"""
Metric logging: a CSV always, wandb or MLflow when asked for and
installed.

The port's own copy of ``CSVLogger`` and ``MetricLogger`` from
``adell_mri_tpu/train/logging_utils.py``: one row per metric, with its
step, time and tags, appended to ``--metric_path``; ``--logger_type
wandb`` or ``mlflow`` also sends the metrics to that tracker when its
package imports, and otherwise warns and keeps to the CSV.
``log_artifact`` uploads a checkpoint with ``--log_model`` and does
nothing without a tracker.
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
    """Fans metrics out to the CSV at ``csv_path`` and, with
    ``logger_type`` ``"wandb"`` or ``"mlflow"``, to that tracker (run
    ``run_name`` of project ``project_name``; wandb's files under
    ``summary_dir``, MLflow's server at ``tracking_uri``)."""

    def __init__(
        self,
        logger_type: Optional[str] = None,
        project_name: Optional[str] = None,
        run_name: Optional[str] = None,
        csv_path: Optional[str] = None,
        config: Optional[Dict] = None,
        summary_dir: Optional[str] = None,
        tracking_uri: Optional[str] = None,
        log_model: bool = False,
    ):
        self.csv = CSVLogger(csv_path) if csv_path else None
        self.backend = None
        self.backend_type = None
        self.log_model = log_model
        if logger_type == "wandb":
            try:
                import wandb

                self.backend = wandb.init(
                    project=project_name, name=run_name, config=config or {},
                    dir=summary_dir,
                )
                self._log = lambda m, step: self.backend.log(m, step=step)
                self.backend_type = "wandb"
            except ImportError:
                logger.warning("wandb not installed; falling back to CSV "
                               "only")
        elif logger_type == "mlflow":
            try:
                import mlflow

                if tracking_uri:
                    mlflow.set_tracking_uri(tracking_uri)
                mlflow.set_experiment(project_name or "adell")
                mlflow.start_run(run_name=run_name)
                self._log = lambda m, step: mlflow.log_metrics(m, step=step)
                self.backend = mlflow
                self.backend_type = "mlflow"
            except ImportError:
                logger.warning("mlflow not installed; falling back to CSV "
                               "only")

    def log_artifact(self, path: str):
        """Uploads a file or a directory to the tracker with
        ``log_model``; a failed upload warns and training goes on."""
        if not self.log_model or self.backend is None:
            return
        try:
            if self.backend_type == "wandb":
                if os.path.isdir(path):
                    # wandb.save takes a glob: a bare directory matches
                    # nothing; "now" uploads before a later deletion
                    self.backend.save(
                        os.path.join(path, "**", "*"),
                        base_path=os.path.dirname(path),
                        policy="now",
                    )
                else:
                    self.backend.save(path, policy="now")
            elif os.path.isdir(path):
                self.backend.log_artifacts(path)
            else:
                self.backend.log_artifact(path)
        except Exception as exc:  # logging must not end training
            logger.warning("log_artifact(%s) failed: %s", path, exc)

    def log_metrics(self, metrics: Dict[str, float], step: int = 0, **tags):
        metrics = {k: float(v) for k, v in metrics.items() if _is_number(v)}
        if self.backend is not None:
            self._log(metrics, step)
        if self.csv is not None:
            for k, v in metrics.items():
                self.csv.log(metric=k, value=v, step=step, time=time.time(),
                             **tags)
            self.csv.write()
        logger.info(
            "step %d | %s", step,
            " ".join(f"{k}={v:.5g}" for k, v in metrics.items()),
        )


def _is_number(v) -> bool:
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


#: each experiment logger flag and the ``MetricLogger`` argument it sets
_LOGGER_FLAGS = {"logger_type": "logger_type", "project_name": "project_name",
                 "summary_name": "run_name", "summary_dir": "summary_dir",
                 "tracking_uri": "tracking_uri", "log_model": "log_model"}


def metric_logger_of(args) -> MetricLogger:
    """The ``MetricLogger`` of a train CLI's flags: ``csv_path`` from
    ``--metric_path`` and an argument for each experiment logger flag the
    CLI takes, as the JAX CLI passes them."""
    kwargs = {arg: getattr(args, flag) for flag, arg in _LOGGER_FLAGS.items()
              if hasattr(args, flag)}
    return MetricLogger(csv_path=args.metric_path, **kwargs)
