"""
``classification test`` and ``predict`` over several checkpoints, the
port's against the JAX CLI's, on the CPU.

Two GP CatNet checkpoints of seeded weights and running statistics on
each side (a JAX one and the port's of the same weights, the GP head's
random features handed to ``from_flax``), three classes, trained with
``--resize_size`` (the metadata says so: both sides scale each case
before the pad): the first with a ``gp_covariance.npy`` and a
``conformal.json``, the second with neither (a zero covariance: the
logits pass as they are). Held against the JAX CLI within ``TOL``: the
records of ``predict --checkpoint`` with ``--ensemble median``, with
``--one_to_one`` over two ID groups, ``--prediction_type logit`` (the
GP correction applied), ``--prediction_type set`` (equal sets), and of
``test --checkpoint`` over two groups; both CLIs refuse ``--one_to_one``
with fewer checkpoints than groups, and ``--ensemble`` of sets.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adell_mri_tpu.__main__ import main as jax_main
from adell_mri_tpu.config.factories import (
    get_classification_network as jget_network,
)
from adell_mri_tpu.train.checkpoints import CheckpointManager as JaxCkpt
from adell_mri_torch.__main__ import main as cli_main
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.train.checkpoints import CheckpointManager
from test_torch_classification_cli import SHAPE, TOL, cohort
from test_torch_gp import gp_in_features, jax_gp_features
from test_torch_unet import random_flax_params

__all__ = ["cohort"]
NETWORK = {"resnet_structure": [[8, 16, 3, 1], [16, 32, 3, 1]],
           "maxpool_structure": [[2, 2, 2], [2, 2, 1]],
           "batch_ensemble": 2, "gaussian_process": True}
GROUPS = ["case_0,case_1,case_2", "case_3,case_4,case_5"]


@pytest.fixture(scope="module")
def runs(cohort):
    """Two run directories a side, the fold directories named as the
    CLIs' ``--checkpoint`` takes them."""
    metadata = {
        "network_config": NETWORK, "n_classes": 3, "net_type": "cat",
        "transform_arguments": {
            "image_keys": ["T2"], "label_key": "grade",
            "target_spacing": [1.0, 1.0, 2.0], "target_size": list(SHAPE),
            "resize_size": [14, 14, 8], "adc_keys": [],
            "possible_labels": ["a", "b", "c"]},
    }
    jm = jget_network("cat", NETWORK, n_classes=3)
    x = jnp.zeros((1,) + SHAPE + (1,))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    out = {"jax": [], "torch": []}
    for i in range(2):
        params = jax.tree.map(jnp.asarray,
                              random_flax_params(jm, x, seed=90 + i))
        rng = np.random.default_rng(92 + i)
        bs = jax.tree.map(lambda s: jnp.asarray(rng.uniform(
            0.5, 1.5, s.shape).astype(np.float32)), shapes["batch_stats"])
        jdir, tdir = (cohort / f"serve_{side}_{i}" for side in ("jax",
                                                                "torch"))
        jck = JaxCkpt(str(jdir), name="classification", fold=0,
                      metadata=metadata)
        jck.save(1, {"params": params, "batch_stats": bs},
                 metrics={"val_loss": 0.5})
        jck.wait()
        tck = CheckpointManager(str(tdir), name="classification", fold=0,
                                metadata=metadata)
        tck.save(from_flax(params, bs, gp_features=jax_gp_features(
            gp_in_features(params))), step=1, value=0.5)
        if i == 0:
            a = rng.normal(size=(256, 256)) * 0.05
            cov = (np.eye(256) + a @ a.T).astype(np.float32)
            conf = json.dumps({"q_hat": 0.8, "alpha": 0.2,
                               "n_calibration": 4})
            for d in (jck.dir, tck.dir):
                np.save(f"{d}/gp_covariance.npy", cov)
                with open(f"{d}/conformal.json", "w") as f:
                    f.write(conf)
        out["jax"].append(jck.dir)
        out["torch"].append(tck.dir)
    return out


def _both(capsys, cohort, runs, mode, *extra, output=True):
    """The JSON each CLI writes (``predict``) or prints (``test``) for
    ``extra`` with its own runs (``{ckpt_i}`` in ``extra`` reads as the
    side's i-th fold directory; the default ``--checkpoint_dir`` is the
    first run)."""
    got = {}
    for side, main in (("jax", jax_main), ("torch", cli_main)):
        args = [a.format(ckpt_0=runs[side][0], ckpt_1=runs[side][1])
                for a in extra]
        path = cohort / f"serve_{side}.json"
        capsys.readouterr()
        main(["classification", mode, "--dataset_json",
              str(cohort / "ds.json"), "--dev", "cpu", "--checkpoint_dir",
              str(runs[side][0]).rsplit("/", 1)[0], *args]
             + (["--output_path", str(path)] if output else []))
        text = capsys.readouterr().out
        got[side] = (json.loads(path.read_text()) if output else json.loads(
            [ln for ln in text.splitlines() if ln.startswith("[")][-1]))
    return got


def _same_records(got):
    want, have = got["jax"], got["torch"]
    assert len(have) == len(want)
    for w, h in zip(want, have):
        assert h["checkpoint"].replace("_torch_", "_jax_") == w["checkpoint"]
        assert set(h) == set(w) and h["iteration"] == w["iteration"]
        assert h["prediction_ids"] == w["prediction_ids"]
        assert h.get("n_predictions") == w.get("n_predictions")
        for pid, v in w["predictions"].items():
            np.testing.assert_allclose(h["predictions"][pid], v, atol=TOL,
                                       rtol=0)


CKPTS = ["--checkpoint", "{ckpt_0}", "{ckpt_1}"]


def test_predict_median_ensemble_matches_jax(cohort, runs, capsys):
    got = _both(capsys, cohort, runs, "predict", *CKPTS, "--ensemble",
                "median")
    assert got["torch"][-1]["checkpoint"] == "ensemble"
    assert all(len(v) == 3 for v in got["torch"][-1]["predictions"]
               .values())
    _same_records(got)


def test_predict_one_to_one_and_logits_match_jax(cohort, runs, capsys):
    got = _both(capsys, cohort, runs, "predict", *CKPTS, "--one_to_one",
                "--prediction_ids", *GROUPS, "--prediction_type", "logit")
    assert [r["iteration"] for r in got["torch"]] == [0, 1]
    _same_records(got)


def test_predict_sets_match_jax(cohort, runs, capsys):
    got = _both(capsys, cohort, runs, "predict", "--prediction_type", "set")
    assert got["torch"] == got["jax"]
    assert all(v and set(v) <= {0, 1, 2} for v in got["torch"].values())
    assert any(len(v) > 1 for v in got["torch"].values())


def test_test_over_checkpoints_and_groups_matches_jax(cohort, runs, capsys):
    got = _both(capsys, cohort, runs, "test", *CKPTS, "--test_ids",
                *GROUPS, "--metric_path", str(cohort / "serve_m.csv"),
                output=False)
    want, have = got["jax"], got["torch"]
    assert [r["iteration"] for r in have] == [0, 0, 1, 1]
    for w, h in zip(want, have):
        assert h.pop("checkpoint").replace("_torch_", "_jax_") == w.pop(
            "checkpoint")
        assert set(h) == set(w)
        for k, v in w.items():
            if isinstance(v, float) and np.isnan(v):
                assert np.isnan(h[k]), k
            else:
                assert abs(h[k] - v) <= TOL, (k, h[k], v)


@pytest.mark.parametrize("mode, extra, match", [
    ("test", ["--checkpoint", "{ckpt_0}", "--one_to_one", "--test_ids",
              *GROUPS], "one checkpoint per"),
    ("predict", [*CKPTS, "--ensemble", "mean", "--prediction_type", "set"],
     "--ensemble cannot aggregate")])
def test_refusals_match_jax(cohort, runs, capsys, mode, extra, match):
    for side, main in (("jax", jax_main), ("torch", cli_main)):
        args = [a.format(ckpt_0=runs[side][0], ckpt_1=runs[side][1])
                for a in extra]
        if mode == "predict":
            args += ["--output_path", str(cohort / "unused.json")]
        with pytest.raises(ValueError, match=match):
            main(["classification", mode, "--dataset_json",
                  str(cohort / "ds.json"), "--dev", "cpu",
                  "--checkpoint_dir", str(runs[side][0]).rsplit("/", 1)[0],
                  *args])
