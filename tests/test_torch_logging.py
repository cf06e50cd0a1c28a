"""
The port's ``MetricLogger`` against the JAX package's, on the CPU.

Neither wandb nor mlflow is installed here (or on the card): each
``logger_type`` gives the same CSV and the same warning in both
packages. With a stand-in
``wandb`` or ``mlflow`` module in ``sys.modules`` both packages make the
same calls on it, ``log_artifact`` included (a file and a directory,
with and without ``log_model``). The wall clock is held still while they
log, so that the files compare whole (rows whose tags differ from the
first row's append under its header in both packages, shifted).
``compare_loggers`` is also what the CLI tests hold each logger flag's
arguments to.
"""

import contextlib
import logging
import sys
import types
from unittest import mock

import pytest

from adell_mri_tpu.train import logging_utils as jlog
from adell_mri_torch.train import logging_utils as tlog

LOGGERS = {"jax": jlog.logger.name, "port": tlog.logger.name}
METRICS = [({"loss": 0.5, "acc": 1.0, "note": "text", "n": 3}, 0,
            {"fold": 0}),
           ({"loss": 0.25, "val_auc": float("nan")}, 2,
            {"fold": 0, "phase": "final"})]


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@contextlib.contextmanager
def warnings_of(name):
    """The warning messages logged to logger ``name`` within the block."""
    handler = _Records()
    log = logging.getLogger(name)
    log.addHandler(handler)
    try:
        yield handler.messages
    finally:
        log.removeHandler(handler)


def csv_rows(path):
    """The lines of a metric CSV."""
    with open(path) as f:
        return f.read().splitlines()


def compare_loggers(kwargs, tmp_path, artifact=None):
    """Both packages' ``MetricLogger(**kwargs)`` (each writing its own
    CSV) log the same metrics, and ``log_artifact(artifact)``: the same
    warnings and CSV rows."""
    rows, warned = {}, {}
    for tag, mod in (("jax", jlog), ("port", tlog)):
        path = tmp_path / f"{tag}_metrics.csv"
        with warnings_of(LOGGERS[tag]) as messages, mock.patch(
                "time.time", return_value=1.0e9):
            metric_logger = mod.MetricLogger(**{**kwargs,
                                                "csv_path": str(path)})
            for metrics, step, tags in METRICS:
                metric_logger.log_metrics(metrics, step=step, **tags)
            if artifact is not None:
                metric_logger.log_artifact(str(artifact))
        rows[tag], warned[tag] = csv_rows(path), messages
    assert rows["port"] == rows["jax"]
    assert warned["port"] == warned["jax"]
    return rows["port"], warned["port"]


@pytest.mark.parametrize("logger_type", [None, "wandb", "mlflow",
                                         "tensorboard"])
def test_without_the_trackers(logger_type, tmp_path):
    rows, warned = compare_loggers(
        dict(logger_type=logger_type, project_name="p", run_name="r",
             log_model=True), tmp_path, artifact=tmp_path)
    assert [r.split(",")[1] for r in rows] == [
        "metric", "loss", "acc", "n", "loss", "val_auc"]
    want = (f"{logger_type} not installed; falling back to CSV only"
            if logger_type in ("wandb", "mlflow") else None)
    assert warned == ([want] if want else [])


class _Calls:
    """A stand-in tracker module that records every call made on it (and
    on the run object ``init`` returns)."""

    def __init__(self, name):
        self.calls = []
        self.module = types.ModuleType(name)
        record = self.record
        for fn in ("set_tracking_uri", "set_experiment", "start_run",
                   "log_metrics", "log_artifact", "log_artifacts"):
            setattr(self.module, fn, record(fn))
        run = types.SimpleNamespace(log=record("run.log"),
                                    save=record("run.save"))

        def init(**kw):
            self.calls.append(("init", (), kw))
            return run

        self.module.init = init

    def record(self, name):
        def fn(*args, **kw):
            self.calls.append((name, args, kw))
        return fn


@pytest.mark.parametrize("backend", ["wandb", "mlflow"])
@pytest.mark.parametrize("log_model", [False, True])
@pytest.mark.parametrize("artifact", ["dir", "file"])
def test_with_a_tracker(backend, log_model, artifact, tmp_path,
                        monkeypatch):
    target = tmp_path / "ckpt"
    target.mkdir()
    if artifact == "file":
        target = target / "model.pt"
        target.write_text("weights")
    calls = {}
    for tag, mod in (("jax", jlog), ("port", tlog)):
        fake = _Calls(backend)
        monkeypatch.setitem(sys.modules, backend, fake.module)
        metric_logger = mod.MetricLogger(
            logger_type=backend, project_name="proj", run_name="run",
            csv_path=str(tmp_path / f"{tag}.csv"), config={"a": 1},
            summary_dir=str(tmp_path / "summaries"),
            tracking_uri="file:mlruns", log_model=log_model)
        assert metric_logger.backend_type == backend
        with mock.patch("time.time", return_value=1.0e9):
            for metrics, step, tags in METRICS:
                metric_logger.log_metrics(metrics, step=step, **tags)
        metric_logger.log_artifact(str(target))
        calls[tag] = fake.calls
    assert calls["port"] == calls["jax"]
    uploads = [c for c in calls["port"]
               if c[0] in ("run.save", "log_artifact", "log_artifacts")]
    assert len(uploads) == int(log_model)
    assert csv_rows(tmp_path / "port.csv") == csv_rows(tmp_path / "jax.csv")


class _Stop(Exception):
    pass


def logger_arguments(monkeypatch, jax_module, flags, run):
    """The keyword arguments that the JAX CLI (``jax_module``'s
    ``MetricLogger``) and the port's CLI build their metric logger with
    from ``flags``: ``run(tag, flags)`` runs the ``"jax"`` or the
    ``"port"`` CLI, which stops there."""
    seen = {}

    def recorder(tag):
        def make(**kwargs):
            seen[tag] = kwargs
            raise _Stop
        return make

    monkeypatch.setattr(jax_module, "MetricLogger", recorder("jax"))
    monkeypatch.setattr(tlog, "MetricLogger", recorder("port"))
    for tag in ("jax", "port"):
        with pytest.raises(_Stop):
            run(tag, flags)
    monkeypatch.undo()
    return seen
