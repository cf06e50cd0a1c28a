"""
The port's self-supervised entry points on the CPU.

``ssl train --dev cpu`` pretrains a tiny VICReg network (a CatNet
backbone in ``sample_configs/ssl-resnet.yaml``'s nesting, two stages of
widths 8 and 16 with its first and last pools) on a 4-case 20x20x10
synthetic cohort with random crops of 16x16x8, writes the JAX trainer's
metadata keys and resumes; every ported method trains an epoch (I-JEPA
at the factory's layout, cut to a tiny width). The JAX CLI trains a
VICReg checkpoint on the same cohort (its TrivialAugment registry cut to
one op, so that its augmentation compiles in seconds: the registry plays
no part in what is compared); its parameters and statistics pass through
``from_flax`` into a port checkpoint, and the port's ``ssl
predict_folder`` JSON equals the JAX CLI's within 1.5e-4 (features
rounded to 4 decimals); ``ssl model_to_export`` (and
``model_to_torchscript``) of that checkpoint in both packages write the
same sidecar, and the port's artifact gives the JAX artifact's output and
the live port model's within 1e-5; ``--logger_type wandb`` gives the
metric logger the JAX CLI's arguments. The refusals raise
``NotImplementedError`` with a message; the three JAX CLI paths that
fail (I-JEPA with a random crop other than the base size;
``predict_folder`` and ``model_to_export`` on an I-JEPA checkpoint) are
pinned beside the port's refusal.
"""

import csv
import json
import os

import flax
import jax
import numpy as np
import pytest
import torch
import yaml

from adell_mri_tpu.__main__ import main as jax_main
from adell_mri_tpu.config.factories import get_ssl_network as jget_ssl_network
from adell_mri_tpu.train.checkpoints import CheckpointManager as JaxCkpt
from adell_mri_tpu.transforms import augment as jA
from adell_mri_tpu.transforms import pipeline as jpipe
from adell_mri_torch.__main__ import main as cli_main
from adell_mri_torch.data import nifti as tnifti
from adell_mri_tpu.entrypoints.ssl import train as jssl_train
from adell_mri_tpu.train.export import load_exported as jload_exported
from adell_mri_torch.config.factories import (
    get_ssl_network as tget_ssl_network,
)
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.train.checkpoints import CheckpointManager
from adell_mri_torch.train.export import adell_ops, load_exported
from test_torch_classification import _close
from test_torch_logging import compare_loggers, logger_arguments

LPS = np.diag([-1.0, -1.0, 2.0, 1.0])
SHAPE = (20, 20, 10)
CROP = (16, 16, 8)
N_CASES = 4
NETWORK = {
    "backbone_args": {
        "spatial_dim": 3, "in_channels": 1,
        "structure": [[8, 8, 3, 1], [16, 16, 3, 1]],
        "maxpool_structure": [[2, 2, 1], [2, 2, 2]],
        "res_type": "resnet"},
    "projection_head_args": {"in_channels": 16, "structure": [32, 16]},
    "prediction_head_args": {"in_channels": 16, "structure": [24, 16]},
    "norm_fn": "batch", "act_fn": "swish",
    "batch_size": 2, "learning_rate": 0.01, "weight_decay": 0.001,
}
IJEPA = {"patch_size": [4, 4, 4], "embed_dim": 16, "n_blocks": 1,
         "n_heads": 2, "predictor_dim": 8, "predictor_blocks": 1,
         "batch_size": 2, "learning_rate": 0.01, "weight_decay": 0.001}
METADATA_KEYS = {"network_config", "ssl_method", "transform_arguments",
                 "monitor", "mode"}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """Four cases of smooth noise with a bright block; a folder of them
    for ``predict_folder``."""
    root = tmp_path_factory.mktemp("ssl_cohort")
    (root / "folder").mkdir()
    rng = np.random.default_rng(0)
    ds = {}
    for i in range(N_CASES):
        img = rng.normal(size=SHAPE).astype(np.float32)
        img[4 + i:10 + i, 5:12, 2:6] += 3.0
        path = str(root / f"case_{i}.nii.gz")
        tnifti.write_nifti(path, img, LPS)
        tnifti.write_nifti(str(root / "folder" / f"case_{i}.nii.gz"), img,
                           LPS)
        ds[f"case_{i}"] = {"image": path}
    (root / "ds.json").write_text(json.dumps(ds))
    (root / "ssl.yaml").write_text(yaml.safe_dump(NETWORK))
    (root / "ijepa.yaml").write_text(yaml.safe_dump(IJEPA))
    return root


def _train_args(root, ckpt, *extra, config="ssl.yaml"):
    return [
        "--dataset_json", str(root / "ds.json"), "--image_keys", "image",
        "--config_file", str(root / config),
        "--pad_size", *map(str, SHAPE), "--target_spacing", "1", "1", "2",
        "--max_epochs", "2", "--dev", "cpu", "--seed", "3",
        "--checkpoint_dir", str(ckpt), "--metric_path",
        str(ckpt / "metrics.csv"), *extra,
    ]


def test_train_resume_and_metadata(cohort, caplog):
    """VICReg in f32, 2 epochs of 2 steps on random crops: a finite
    loss, the JAX trainer's metadata keys, the weights and the last state;
    then a resume to a third epoch."""
    ckpt = cohort / "ckpt_vicreg"
    args = _train_args(cohort, ckpt, "--random_crop_size", *map(str, CROP))
    cli_main(["ssl", "train", *args])
    fold = ckpt / "ssl_vicreg_fold0"
    assert sorted(os.listdir(fold)) == ["last.pt", "metadata.json",
                                        "model.pt"]
    meta = json.loads((fold / "metadata.json").read_text())
    assert set(meta) == METADATA_KEYS and meta["ssl_method"] == "vicreg"
    assert meta["transform_arguments"] == {
        "image_keys": ["image"], "sample_channels": None,
        "target_size": list(SHAPE), "crop_size": list(CROP),
        "target_spacing": [1.0, 1.0, 2.0]}
    assert meta["network_config"]["n_channels"] == 1
    with open(ckpt / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["value"]) for r in rows if r["metric"] == "loss"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert {"invariance", "variance", "covariance"} <= {
        r["metric"] for r in rows}
    last = torch.load(fold / "last.pt", weights_only=True)
    assert last["epoch"] == 2 and last["step"] == 4
    assert last["ema_params"] is None and last["variables"]
    caplog.set_level("INFO")
    cli_main(["ssl", "train", *args, "--resume_from_last",
              "--max_epochs", "3"])
    assert "resuming from epoch 2" in caplog.text
    last = torch.load(fold / "last.pt", weights_only=True)
    assert last["epoch"] == 3 and last["step"] == 6


@pytest.mark.parametrize("method, extra", [
    ("barlow_twins", []), ("simclr", []), ("simsiam", []),
    ("byol", []), ("vicreg", ["--ema", "--stop_gradient"]),
    ("ijepa", []), ("vicreg", ["--precision", "bf16"]),
])
def test_every_ported_method_trains(cohort, method, extra):
    """An epoch of each method: BYOL and I-JEPA (and ``--ema``) keep an
    EMA shadow; I-JEPA trains on the base-size image."""
    ckpt = cohort / f"ckpt_{method}_{len(extra)}"
    config = "ijepa.yaml" if method == "ijepa" else "ssl.yaml"
    crop = [] if method == "ijepa" else ["--random_crop_size",
                                         *map(str, CROP)]
    cli_main(["ssl", "train", *_train_args(
        cohort, ckpt, "--ssl_method", method, "--max_epochs", "1", *crop,
        *extra, config=config)])
    fold = ckpt / f"ssl_{method}_fold0"
    last = torch.load(fold / "last.pt", weights_only=True)
    assert last["step"] == N_CASES // 2
    assert (last["ema_params"] is not None) == (
        method in ("byol", "ijepa") or "--ema" in extra)
    state = torch.load(fold / "model.pt", weights_only=True)
    assert all(bool(torch.isfinite(v).all()) for v in state.values())


def _small_registry(monkeypatch):
    monkeypatch.setattr(
        jpipe, "AugmentationWorkhorse",
        lambda augmentations=None, n_transforms=1, ndim=3:
        jA.AugmentationWorkhorse(
            ["scale_intensity"],
            n_transforms, ndim))


@pytest.fixture(scope="module")
def jax_vicreg(cohort):
    """The JAX CLI's VICReg checkpoint (one epoch) and a port checkpoint
    of its parameters and statistics."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        _small_registry(monkeypatch)
        jdir = cohort / "jax_ckpt"
        jax_main(["ssl", "train", *_train_args(
            cohort, jdir, "--random_crop_size", *map(str, CROP),
            "--max_epochs", "1")])
    jck = JaxCkpt(str(jdir), name="ssl_vicreg", fold=0)
    restored = jck.restore(jck.best_step())
    meta = jck.load_metadata()
    tdir = cohort / "torch_from_jax"
    CheckpointManager(str(tdir), name="ssl_vicreg", fold=0,
                      metadata=meta).save(from_flax(
                          restored["params"],
                          restored["variables"]["batch_stats"]))
    return jdir, tdir


def test_predict_folder_matches_jax(cohort, jax_vicreg):
    """The JAX CLI's checkpoint served by both CLIs: the same files, each
    feature within 1.5e-4 (4-decimal rounding on both sides)."""
    jdir, tdir = jax_vicreg
    jout, tout = cohort / "jax_features.json", cohort / "features.json"
    common = ["--input_folder", str(cohort / "folder"), "--dev", "cpu"]
    jax_main(["ssl", "predict_folder", "--checkpoint_dir", str(jdir),
              "--output_path", str(jout), *common])
    cli_main(["ssl", "predict_folder", "--checkpoint_dir", str(tdir),
              "--output_path", str(tout), *common])
    want, got = json.loads(jout.read_text()), json.loads(tout.read_text())
    assert sorted(got) == sorted(want) == [
        f"case_{i}.nii.gz" for i in range(N_CASES)]
    for name, v in want.items():
        assert len(got[name]["features"]) == len(v["features"]) == 16
        np.testing.assert_allclose(got[name]["features"], v["features"],
                                   atol=1.5e-4, rtol=0)


@pytest.mark.parametrize("args, match", [
    (["train", "--ssl_method", "dino", "--sample_channels", "2"],
     "sample_channels"),
    (["train", "--ssl_method", "ibot", "--sample_channels", "2"],
     "sample_channels"),
    (["train", "--ssl_method", "mae", "--sample_channels", "2"],
     "sample_channels"),
    (["train", "--ssl_method", "vicregl", "--sample_channels", "2"],
     "sample_channels"),
    (["train", "--sample_channels", "2"], "sample_channels"),
    (["train_2d"], "train_2d"),
])
def test_refusals(cohort, args, match):
    ckpt = cohort / "ckpt_refused"
    rest = _train_args(cohort, ckpt) if args[0] == "train" else []
    with pytest.raises(NotImplementedError, match=match):
        cli_main(["ssl", *args, *rest])


@pytest.mark.parametrize("args", [
    ["train", "--logger_type", "wandb"], ["model_to_export"],
    ["model_to_torchscript"]])
def test_ported_modes_match_jax(cohort, jax_vicreg, args, monkeypatch,
                                tmp_path):
    """``train --logger_type wandb``: both CLIs build their metric logger
    with the same arguments, with which both packages' loggers write the
    same CSV and give the same warning (wandb is not installed).
    ``model_to_export`` and its spelling ``model_to_torchscript`` on the
    JAX CLI's checkpoint (both CLIs, B=2): the same sidecar, and the port's
    artifact, which records the K1 op, gives the live port model's output
    and the JAX artifact's within 1e-5 of their scale (f32)."""
    jdir, tdir = jax_vicreg
    if args[0] == "train":

        def run(tag, flags):
            train_args = _train_args(cohort, tmp_path / "ckpt", *flags[1:])
            (jax_main if tag == "jax" else cli_main)(
                ["ssl", "train", *train_args])

        seen = logger_arguments(monkeypatch, jssl_train, args, run)
        assert seen["port"] == seen["jax"]
        _, warned = compare_loggers(seen["port"], tmp_path)
        assert warned == ["wandb not installed; falling back to CSV only"]
        return
    jpath, tpath = tmp_path / "jax.bin", tmp_path / "port.pt2"
    jax_main(["ssl", args[0], "--checkpoint_dir", str(jdir),
              "--output_path", str(jpath), "--batch_size", "2"])
    cli_main(["ssl", args[0], "--checkpoint_dir", str(tdir),
              "--output_path", str(tpath), "--batch_size", "2",
              "--dev", "cpu"])
    jfn, jmeta = jload_exported(str(jpath))
    tfn, tmeta = load_exported(str(tpath))
    assert tmeta == jmeta
    assert tmeta["input_shape"] == [2, *SHAPE, 1]
    assert adell_ops(torch.export.load(str(tpath))) == {
        "adell.conv3d_igemm.default": 5}
    x = np.random.default_rng(7).normal(size=(2, *SHAPE, 1)).astype(
        np.float32)
    want = np.asarray(jfn(x))
    got = tfn(torch.from_numpy(x))
    mngr = CheckpointManager(str(tdir), name="ssl_vicreg", fold=0)
    model = tget_ssl_network("vicreg", mngr.load_metadata()[
        "network_config"], image_size=SHAPE)
    model.load_state_dict(mngr.load_state_dict())
    with torch.no_grad():
        live = model.eval()(torch.from_numpy(x))
    _close(got, want, 1e-5)
    _close(got, live, 1e-5)


def test_ijepa_with_a_random_crop_fails_in_jax_and_is_refused(cohort,
                                                              monkeypatch):
    """The JAX CLI builds I-JEPA at the crop size and steps it on the
    base-size image: the first step fails on the positional embedding's
    shape. The port refuses the run before it starts."""
    _small_registry(monkeypatch)
    args = _train_args(cohort, cohort / "ckpt_ijepa_crop", "--ssl_method",
                       "ijepa", "--random_crop_size", *map(str, CROP),
                       "--max_epochs", "1", config="ijepa.yaml")
    with pytest.raises(flax.errors.ScopeParamShapeError,
                       match="pos_embedding"):
        jax_main(["ssl", "train", *args])
    with pytest.raises(NotImplementedError, match="random_crop_size"):
        cli_main(["ssl", "train", *args])


def _ijepa_checkpoints(cohort, tag):
    """A JAX I-JEPA checkpoint (seeded init) and a port checkpoint
    directory of its metadata: the refusals read no weights."""
    meta = {"network_config": IJEPA, "ssl_method": "ijepa",
            "transform_arguments": {"image_keys": ["image"],
                                    "target_size": list(SHAPE),
                                    "target_spacing": [1.0, 1.0, 2.0]}}
    jm = jget_ssl_network("ijepa", IJEPA)
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "masking": jax.random.PRNGKey(1)},
                     np.zeros((1,) + SHAPE + (1,), np.float32))["params"]
    jdir, tdir = cohort / f"jax_{tag}", cohort / f"torch_{tag}"
    jck = JaxCkpt(str(jdir), name="ssl_ijepa", fold=0, metadata=meta)
    jck.save(1, {"params": params}, metrics={})
    jck.wait()
    CheckpointManager(str(tdir), name="ssl_ijepa", fold=0, metadata=meta)
    return jdir, tdir


def test_ijepa_model_to_export_fails_in_jax_and_is_refused(cohort,
                                                           tmp_path):
    """The JAX exporter applies I-JEPA without the masking stream its
    forward draws from; the port refuses an I-JEPA checkpoint."""
    jdir, tdir = _ijepa_checkpoints(cohort, "ijepa_export")
    common = ["--ssl_method", "ijepa", "--output_path",
              str(tmp_path / "unused")]
    with pytest.raises(flax.errors.InvalidRngError, match="masking"):
        jax_main(["ssl", "model_to_export", "--checkpoint_dir", str(jdir),
                  *common])
    with pytest.raises(NotImplementedError, match="I-JEPA"):
        cli_main(["ssl", "model_to_export", "--checkpoint_dir", str(tdir),
                  "--dev", "cpu", *common])


def test_ijepa_predict_folder_fails_in_jax_and_is_refused(cohort):
    """The JAX CLI asks I-JEPA for ``ret="representation"``, a keyword
    ``IJEPA.__call__`` does not take (its ``init`` without a masking
    stream passes in this flax, which falls back to the params stream);
    the port refuses an I-JEPA checkpoint."""
    jdir, tdir = _ijepa_checkpoints(cohort, "ijepa")
    common = ["--input_folder", str(cohort / "folder"), "--dev", "cpu",
              "--output_path", str(cohort / "unused.json"),
              "--ssl_method", "ijepa"]
    with pytest.raises(TypeError, match="ret"):
        jax_main(["ssl", "predict_folder", "--checkpoint_dir", str(jdir),
                  *common])
    with pytest.raises(NotImplementedError, match="I-JEPA"):
        cli_main(["ssl", "predict_folder", "--checkpoint_dir", str(tdir),
                  *common])
