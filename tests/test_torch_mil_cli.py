"""
``classification_mil train``, ``test`` and ``predict``, the port's
against the JAX package's, on the CPU.

A 6-case cohort of 16x16x4 volumes (4 slices of 16x16, a bright block in
the positives) and a yaml of tiny widths with
``sample_configs/transformable-transformer.yaml``'s other keys beside
them (which reach no module in either CLI). For each ``--mil_method`` the
two CLIs train from the same initial weights (the JAX CLI's init, moved
into the port's model): two epochs; then, for ``standard``, a second run
warm-started from the first (``--module_paths``) with ``--freeze_module``.
Held: the metadata; the weights each run kept within 1e-4 of each leaf's
scale; the second run's slice encoder bit-equal to the first's;
``test`` within 1e-4 on every metric; ``predict`` with both runs'
checkpoints and ``--ensemble mean`` within 1e-4 on every record.
"""

import json

import jax
import numpy as np
import pytest
import yaml

from adell_mri_tpu.entrypoints.classification_mil import predict as jpredict
from adell_mri_tpu.entrypoints.classification_mil import test as jtest
from adell_mri_tpu.entrypoints.classification_mil import train as jtrain
from adell_mri_tpu.train.checkpoints import CheckpointManager as JaxCkpt
from adell_mri_torch.__main__ import main as cli_main
from adell_mri_torch.data import nifti as tnifti
from adell_mri_torch.entrypoints.classification_mil import (
    predict as tpredict,
)
from adell_mri_torch.entrypoints.classification_mil import test as ttest
from adell_mri_torch.entrypoints.classification_mil import train as ttrain
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.train.checkpoints import CheckpointManager

LPS = np.diag([-1.0, -1.0, 2.0, 1.0])
SHAPE = (16, 16, 4)
NETWORK = {"first_depth": 4, "n_blocks": 2, "attention_dim": 8,
           "embed_dim": 8, "n_heads": 2, "transformer_blocks": 1}
# transformable-transformer.yaml's keys that no module reads
UNUSED = {"dim": 2, "use_class_token": True, "number_of_blocks": 2,
          "classification_structure": [16, 16], "mlp_structure": [16]}
TOL = 1e-4


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("mil_cohort")
    rng = np.random.default_rng(0)
    ds = {}
    for i in range(6):
        label = i % 2
        img = rng.normal(size=SHAPE).astype(np.float32)
        if label:
            img[4:10, 5:12, 1:3] += 3.0
        path = str(root / f"case_{i}_T2.nii.gz")
        tnifti.write_nifti(path, img, LPS)
        ds[f"case_{i}"] = {"T2": path, "label": label}
    (root / "ds.json").write_text(json.dumps(ds))
    (root / "mil.yaml").write_text(yaml.safe_dump(
        {**NETWORK, **UNUSED, "learning_rate": 0.01, "batch_size": 2}))
    return root


def _train_args(root, ckpt, method, *extra):
    return [
        "--dataset_json", str(root / "ds.json"), "--image_keys", "T2",
        "--config_file", str(root / "mil.yaml"),
        "--pad_size", *map(str, SHAPE), "--target_spacing", "1", "1", "2",
        "--n_folds", "1", "--dev", "cpu", "--seed", "0",
        "--mil_method", method, "--checkpoint_dir", str(ckpt),
        "--metric_path", str(ckpt / "metrics.csv"), *extra,
    ]


@pytest.fixture(scope="module")
def runs(cohort):
    """Each side's runs: ``standard`` (and its warm-started, frozen
    second run) and ``transformer``."""
    build = ttrain.build_mil_model
    inits = {}

    def from_jax_init(net_cfg, method, n_classes, in_channels=1):
        model = build(net_cfg, method, n_classes, in_channels)
        if method not in inits:
            jm = jtrain.build_mil_model(net_cfg, method, n_classes)
            inits[method] = from_flax(jm.init(
                {"params": jax.random.PRNGKey(0)},
                np.zeros((1,) + SHAPE + (1,), np.float32))["params"])
        model.load_state_dict(inits[method])
        return model

    mp = pytest.MonkeyPatch()
    mp.setattr(ttrain, "build_mil_model", from_jax_init)
    dirs = {}
    try:
        for side, main in (("jax", jtrain.main), ("torch", ttrain.main)):
            for method in ("standard", "transformer"):
                d = cohort / f"{side}_{method}"
                main(_train_args(cohort, d, method, "--max_epochs", "2"))
                dirs[side, method] = d
            d = cohort / f"{side}_frozen"
            main(_train_args(
                cohort, d, "standard", "--max_epochs", "1",
                "--module_paths", str(dirs[side, "standard"] / "mil_fold0"),
                "--freeze_module"))
            dirs[side, "frozen"] = d
    finally:
        mp.undo()
    return dirs


def _weights(side, run):
    if side == "torch":
        return CheckpointManager(str(run), name="mil",
                                 fold=0).load_state_dict()
    ck = JaxCkpt(str(run), name="mil", fold=0)
    return from_flax(ck.restore(ck.best_step())["params"])


@pytest.mark.parametrize("run", ["standard", "transformer", "frozen"])
def test_mil_train_matches_jax(runs, run):
    meta = {side: json.loads((runs[side, run] / "mil_fold0"
                              / "metadata.json").read_text())
            for side in ("jax", "torch")}
    for key in ("mil_method", "n_classes", "network_config"):
        assert meta["torch"][key] == meta["jax"][key], key
    t_args = meta["torch"]["transform_arguments"]
    assert {k: t_args[k] for k in meta["jax"]["transform_arguments"]} == (
        meta["jax"]["transform_arguments"])
    got, want = _weights("torch", runs["torch", run]), _weights(
        "jax", runs["jax", run])
    assert set(got) == set(want)
    for k, v in want.items():
        err = float((got[k] - v).abs().max())
        assert err <= TOL * max(1.0, float(v.abs().max())), (k, err)
    if run == "frozen":
        start = _weights("torch", runs["torch", "standard"])
        module = [k for k in got if k.startswith("module.")]
        assert len(module) == 8
        for k in module:
            assert (got[k] == start[k]).all(), k
        assert not (got["Dense_1.weight"] == start["Dense_1.weight"]).all()


def _last_json(out: str):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith(("{", "["))][-1])


@pytest.mark.parametrize("run", ["standard", "transformer"])
def test_mil_test_matches_jax(runs, cohort, capsys, run):
    out = {}
    for side, main in (("jax", jtest.main), ("torch", ttest.main)):
        main(["--dataset_json", str(cohort / "ds.json"), "--dev", "cpu",
              "--checkpoint_dir", str(runs[side, run]),
              "--metric_path", str(runs[side, run] / "test.csv")])
        out[side] = _last_json(capsys.readouterr().out)
    assert set(out["torch"]) == set(out["jax"])
    assert out["torch"]["n_cases"] == 6
    for k, v in out["jax"].items():
        if isinstance(v, float) and np.isnan(v):
            assert np.isnan(out["torch"][k]), k
        else:
            assert abs(out["torch"][k] - v) <= TOL, (k, out["torch"][k], v)


def test_mil_predict_ensemble_matches_jax(runs, cohort, capsys):
    out = {}
    for side, main in (("jax", jpredict.main), ("torch", tpredict.main)):
        main(["--dataset_json", str(cohort / "ds.json"), "--dev", "cpu",
              "--checkpoint_dir", str(runs[side, "standard"]),
              "--checkpoint",
              str(runs[side, "standard"] / "mil_fold0"),
              str(runs[side, "frozen"] / "mil_fold0"),
              "--ensemble", "mean",
              "--output_path", str(cohort / f"pred_{side}.json")])
        out[side] = _last_json(capsys.readouterr().out)
    assert len(out["torch"]) == len(out["jax"]) == 3
    for got, want in zip(out["torch"], out["jax"]):
        assert set(got["predictions"]) == set(want["predictions"])
        for pid, v in want["predictions"].items():
            assert abs(got["predictions"][pid] - v) <= TOL, pid


def test_mil_cli_dispatch(runs, cohort, capsys):
    """``python -m adell_mri_torch classification_mil predict`` serves a
    run in bf16: probabilities within bf16's reach of f32."""
    cli_main(["classification_mil", "predict", "--dataset_json",
              str(cohort / "ds.json"), "--dev", "cpu", "--checkpoint_dir",
              str(runs["torch", "transformer"]), "--precision", "bf16",
              "--output_path", str(cohort / "bf16.json")])
    got = _last_json(capsys.readouterr().out)
    tpredict.main(["--dataset_json", str(cohort / "ds.json"), "--dev",
                   "cpu", "--checkpoint_dir",
                   str(runs["torch", "transformer"]),
                   "--output_path", str(cohort / "f32.json")])
    want = _last_json(capsys.readouterr().out)
    assert set(got) == set(want) == {f"case_{i}" for i in range(6)}
    for pid, v in want.items():
        assert abs(got[pid] - v) <= 5e-2, pid


@pytest.mark.parametrize("source", ["missing", "reference.pt", "other"])
def test_module_warm_start_only_warns(tmp_path, caplog, source):
    """``--module_paths`` that loads nothing (no run there, a reference
    ``.pt``, a run of other widths) warns and leaves the model as it was,
    as the JAX CLI does; it never raises."""
    import logging

    import torch

    from adell_mri_torch.train.checkpoints import subtree_warm_start

    model = ttrain.build_mil_model(NETWORK, "standard", 2)
    if source == "other":
        other = ttrain.build_mil_model(
            {**NETWORK, "first_depth": 6}, "standard", 2)
        CheckpointManager(str(tmp_path), name="other").save(
            other.state_dict())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with caplog.at_level(logging.WARNING):
        n = subtree_warm_start(model, str(tmp_path / source), "module",
                               ("module", ""), required=False)
    assert n == 0
    assert any(r.levelno == logging.WARNING for r in caplog.records)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("keys, want", [
    (["encoder_backbone.a", "ResNetBackbone_0.b"], ["a"]),
    (["ResNetBackbone_0.b", "head.c"], ["b"]),
    (["backbone.ResNetBackbone_0.d", "head.c"], ["d"]),
    (["head.c"], ["head.c"]),
])
def test_subtree_sources_in_order(keys, want):
    """``_subtree`` takes the first source prefix that matches a leaf:
    ``*`` stands for any top-level name, ``""`` for the whole tree."""
    import torch

    from adell_mri_torch.train.checkpoints import ENCODER_SOURCES, _subtree

    state = {k: torch.zeros(1) for k in keys}
    assert sorted(_subtree(state, ENCODER_SOURCES)) == want
