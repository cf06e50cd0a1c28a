"""
The classification CLI's training flags, the port's against the JAX
package's, on the CPU.

Two runs of ``classification train`` on each side, from the same initial
weights (the JAX CLI's init, moved into the port's network with the GP
head's random features): the first with ``gaussian_process: true``,
``--resize_size``, ``--accumulate_grad_batches 2`` and
``--calibration_ids`` (left out of the folds); the second warm-started
from the first (``--checkpoint``, ``--exclude_from_state_dict gp``) with
``--freeze_regex ResNetBackbone_0 --not_freeze_regex ActDropNorm``. The
CatNet is the tiny one without batch ensembles, and dropout is the
identity on both sides (their random draws differ), so that the two
trainings can follow each other. Held: the metadata; the weights each
run kept (1e-4 of each leaf's scale; the frozen leaves equal to the
warm start's bit for bit); ``gp_covariance.npy`` (1e-4); ``conformal.json``
(``q_hat`` 1e-6, the rest equal); ``predict --checkpoint`` of both runs
with ``--ensemble mean`` (the GP correction on, 1e-4), ``--prediction_type
set`` (equal sets) and ``test --checkpoint`` of both with ``--one_to_one``
over two ID groups (1e-4).
"""

import json

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch
import yaml

from adell_mri_tpu.__main__ import main as jax_main
from adell_mri_tpu.config.factories import (
    get_classification_network as jget_network,
)
from adell_mri_tpu.entrypoints.classification import train as jtrain
from adell_mri_tpu.train.checkpoints import CheckpointManager as JaxCkpt
from adell_mri_torch.__main__ import main as cli_main
from adell_mri_torch.entrypoints.classification import train as ttrain
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.layers.dropout import Dropout
from test_torch_classification_cli import SHAPE, TOL, _last_json, cohort
from test_torch_gp import gp_in_features, jax_gp_features

NETWORK = {"resnet_structure": [[8, 16, 3, 1], [16, 32, 3, 1]],
           "maxpool_structure": [[2, 2, 2], [2, 2, 1]],
           "gaussian_process": True}
FROZEN = "ResNetBackbone_0"
KEPT = "ActDropNorm"

__all__ = ["cohort"]


def _args(root, ckpt, *extra):
    return [
        "--dataset_json", str(root / "ds.json"), "--image_keys", "T2",
        "--config_file", str(root / "gp.yaml"),
        "--pad_size", *map(str, SHAPE), "--target_spacing", "1", "1", "2",
        "--n_folds", "1", "--dev", "cpu", "--seed", "0",
        "--checkpoint_dir", str(ckpt), "--metric_path",
        str(ckpt / "metrics.csv"), *extra,
    ]


@pytest.fixture(scope="module")
def runs(cohort):
    """Both sides' two runs; returns their directories."""
    (cohort / "gp.yaml").write_text(yaml.safe_dump(
        {**NETWORK, "learning_rate": 0.01, "batch_size": 2}))
    jm = jget_network("cat", NETWORK)
    init = jm.init({"params": jax.random.PRNGKey(0)},
                   np.zeros((1,) + SHAPE + (1,), np.float32))
    state = from_flax(init["params"], init["batch_stats"],
                      gp_features=jax_gp_features(
                          gp_in_features(init["params"])))
    build = ttrain.get_classification_network

    def from_jax_init(*args, **kwargs):
        model = build(*args, **kwargs)
        model.load_state_dict(state)
        return model

    mp = pytest.MonkeyPatch()
    mp.setattr(ttrain, "get_classification_network", from_jax_init)
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    mp.setattr(Dropout, "forward", lambda self, x: x)
    first = ["--max_epochs", "2", "--resize_size", "16", "12", "8",
             "--accumulate_grad_batches", "2",
             "--calibration_ids", "case_4,case_5"]
    dirs = {}
    try:
        for side, main in (("jax", jtrain.main), ("torch", ttrain.main)):
            one, two = cohort / f"flags_{side}_1", cohort / f"flags_{side}_2"
            main(_args(cohort, one, *first))
            main(_args(cohort, two, "--max_epochs", "1", "--checkpoint",
                       str(one / "classification_fold0"),
                       "--exclude_from_state_dict", "gp",
                       "--freeze_regex", FROZEN, "--not_freeze_regex",
                       KEPT))
            dirs[side] = (one, two)
    finally:
        mp.undo()
    return dirs


def _jax_weights(run):
    ck = JaxCkpt(str(run), name="classification", fold=0)
    tree = ck.restore(ck.best_step())
    bs = (tree.get("variables") or {}).get("batch_stats")
    params = tree["params"]
    return from_flax(params, bs, gp_features=jax_gp_features(
        gp_in_features(params)))


def test_metadata_and_sidecars_match(runs):
    """Metadata (``resize_size`` kept, the calibration cases out of the
    folds), ``gp_covariance.npy`` within 1e-4 and ``conformal.json``."""
    for k in range(2):
        meta = {side: json.loads((runs[side][k] / "classification_fold0"
                                  / "metadata.json").read_text())
                for side in runs}
        for key in ("train_pids", "val_pids", "n_classes", "net_type"):
            assert meta["torch"][key] == meta["jax"][key], key
        t_args = meta["torch"]["transform_arguments"]
        assert t_args["resize_size"] == (None if k else [16, 12, 8])
        assert t_args == {**meta["jax"]["transform_arguments"],
                          **{key: t_args[key] for key in t_args
                             if key not in meta["jax"][
                                 "transform_arguments"]}}
        if k == 0:
            assert not {"case_4", "case_5"} & set(
                meta["torch"]["train_pids"] + meta["torch"]["val_pids"])
        cov = {side: np.load(runs[side][k] / "classification_fold0"
                             / "gp_covariance.npy") for side in runs}
        assert cov["torch"].shape == (256, 256)
        np.testing.assert_allclose(cov["torch"], cov["jax"], atol=1e-4,
                                   rtol=0)
    conf = {side: json.loads((runs[side][0] / "classification_fold0"
                              / "conformal.json").read_text())
            for side in runs}
    assert conf["torch"]["n_calibration"] == conf["jax"]["n_calibration"] \
        == 2
    assert conf["torch"]["alpha"] == conf["jax"]["alpha"] == 0.2
    assert abs(conf["torch"]["q_hat"] - conf["jax"]["q_hat"]) <= 1e-6
    assert not (runs["torch"][1] / "classification_fold0"
                / "conformal.json").exists()


def test_trained_weights_match(runs):
    """The kept weights of both runs within 1e-4 of each leaf's scale
    (running statistics 1e-4 of theirs); in the warm-started run the
    frozen leaves (``ResNetBackbone_0`` less its norms) equal the first
    run's bit for bit, the others moved."""
    kept = []
    for k in range(2):
        want = _jax_weights(runs["jax"][k])
        got = torch.load(runs["torch"][k] / "classification_fold0"
                         / "model.pt", weights_only=True)
        assert set(got) == set(want)
        for name, w in want.items():
            scale = max(float(w.abs().max()), 1e-3)
            err = float((got[name] - w).abs().max())
            assert err <= TOL * scale, (k, name, err, scale)
        kept.append(got)
    frozen = [n for n in kept[1] if n.startswith(FROZEN + ".")
              and "ActDropNorm" not in n
              and not n.endswith((".mean", ".var"))]
    assert frozen
    for n in frozen:
        assert torch.equal(kept[1][n], kept[0][n]), n
    moved = [n for n in kept[1] if n.startswith("Dense_")]
    assert any(not torch.equal(kept[1][n], kept[0][n]) for n in moved)


def test_serving_both_runs_matches(runs, cohort, capsys):
    """``predict --checkpoint`` of both runs with ``--ensemble mean`` (GP
    correction from each run's covariance) within 1e-4, ``--prediction_type
    set`` equal, ``test --checkpoint ... --one_to_one`` over two groups
    within 1e-4; the records' schema equal to the JAX CLI's."""
    out = {}
    for side, main in (("jax", jax_main), ("torch", cli_main)):
        one, two = runs[side]
        common = ["--dataset_json", str(cohort / "ds.json"), "--dev", "cpu",
                  "--checkpoint_dir", str(one)]
        ckpts = ["--checkpoint", str(one / "classification_fold0"),
                 str(two / "classification_fold0")]
        main(["classification", "predict", *common, *ckpts, "--ensemble",
              "mean", "--output_path", str(one / "ens.json")])
        main(["classification", "predict", *common, "--prediction_type",
              "set", "--output_path", str(one / "set.json")])
        capsys.readouterr()
        main(["classification", "test", *common, *ckpts, "--one_to_one",
              "--test_ids", "case_0,case_1,case_2", "case_3,case_4,case_5",
              "--metric_path", str(one / "t.csv")])
        out[side] = (json.loads((one / "ens.json").read_text()),
                     json.loads((one / "set.json").read_text()),
                     _last_json(capsys.readouterr().out))
    (jens, jset, jtest), (tens, tset, ttest) = out["jax"], out["torch"]
    assert [r["checkpoint"].replace("_torch_", "_jax_") for r in tens] == [
        r["checkpoint"] for r in jens]
    assert tens[-1]["checkpoint"] == "ensemble"
    for jr, tr in zip(jens, tens):
        assert set(tr) == set(jr) and tr["iteration"] == jr["iteration"]
        assert tr["prediction_ids"] == jr["prediction_ids"]
        for pid, v in jr["predictions"].items():
            assert abs(tr["predictions"][pid] - v) <= TOL, (pid, v)
    assert tens[-1]["n_predictions"] == jens[-1]["n_predictions"]
    assert tset == jset and all(tset.values())
    assert [r["iteration"] for r in ttest] == [0, 1]
    for jr, tr in zip(jtest, ttest):
        assert tr.pop("checkpoint").replace("_torch_", "_jax_") == \
            jr.pop("checkpoint")
        for k, v in jr.items():
            if isinstance(v, float) and np.isnan(v):
                assert np.isnan(tr[k]), k
            else:
                assert abs(tr[k] - v) <= TOL, (k, tr[k], v)
