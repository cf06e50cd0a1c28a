"""
The port's training entry point on the CPU.

``segmentation train --dev cpu`` takes one step on a 2-case 16x16x8
synthetic cohort and writes a checkpoint whose metadata carries what the
JAX package's trainer records; ``segmentation predict --dev cpu`` serves
it. ``--dev`` defaults to cuda and raises where there is no GPU; flags
that are not ported raise ``NotImplementedError``; the experiment logger
flag gives the metric logger the JAX CLI's arguments.
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

from adell_mri_tpu.__main__ import main as jax_main
from adell_mri_tpu.entrypoints.segmentation import train as jtrain
from adell_mri_torch.__main__ import main as cli_main
from adell_mri_torch.data import nifti as tnifti
from adell_mri_torch.entrypoints.segmentation import train as ttrain
from test_torch_logging import compare_loggers, logger_arguments

LPS = np.diag([-1.0, -1.0, 2.0, 1.0])
CONFIG = {
    "spatial_dimensions": 3, "conv_type": "regular",
    "link_type": "residual", "upscale_type": "transpose",
    "norm_type": "instance", "activation_fn": "swish", "depth": [4, 4, 8],
    "kernel_sizes": [3, 3, 3], "strides": [2, 2, 2], "learning_rate": 0.01,
    "loss_fn": {"dice": {}, "focal": {"gamma": 1.0}},
}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cohort")
    rng = np.random.default_rng(0)
    ds = {}
    for i in range(2):
        img = rng.normal(size=(16, 16, 8)).astype(np.float32)
        mask = np.zeros((16, 16, 8), np.float32)
        mask[4:10, 5:12, 2:6] = 1.0
        paths = {}
        for key, data in (("T2", img), ("mask", mask)):
            paths[key] = str(root / f"case_{i}_{key}.nii.gz")
            tnifti.write_nifti(paths[key], data, LPS)
        ds[f"case_{i}"] = paths
    (root / "ds.json").write_text(json.dumps(ds))
    (root / "unet.json").write_text(json.dumps(CONFIG))
    return root


def _train_args(root, ckpt, *extra):
    return [
        "--dataset_json", str(root / "ds.json"), "--image_keys", "T2",
        "--mask_keys", "mask", "--config_file", str(root / "unet.json"),
        "--pad_size", "16", "16", "8", "--target_spacing", "1", "1", "2",
        "--batch_size", "1", "--max_epochs", "1", "--n_folds", "1",
        "--augment", "intensity", "noise", "affine", "flip",
        "--checkpoint_dir", str(ckpt), "--metric_path",
        str(ckpt / "metrics.csv"), *extra,
    ]


def test_train_then_predict_on_cpu(cohort):
    ckpt = cohort / "ckpt"
    cli_main(["segmentation", "train", *_train_args(cohort, ckpt,
                                                    "--dev", "cpu")])
    fold = ckpt / "segmentation_fold0"
    assert sorted(os.listdir(fold)) == ["best.json", "last.pt",
                                        "metadata.json", "model.pt"]
    meta = json.loads((fold / "metadata.json").read_text())
    # the fields the JAX trainer writes, so that predict can rebuild
    assert {"network_config", "transform_arguments", "train_pids",
            "val_pids", "n_classes", "net_type", "monitor", "mode"} <= set(
        meta)
    assert meta["transform_arguments"]["target_size"] == [16, 16, 8]
    assert len(meta["train_pids"]) == len(meta["val_pids"]) == 1
    best = json.loads((fold / "best.json").read_text())
    assert best["step"] == 1 and np.isfinite(best["value"])
    with open(ckpt / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert {r["metric"] for r in rows} >= {"loss", "dice", "val_loss"}
    state = torch.load(fold / "model.pt", weights_only=True)
    assert all(bool(torch.isfinite(v).all()) for v in state.values())

    out = cohort / "pred"
    cli_main(["segmentation", "predict", "--dataset_json",
              str(cohort / "ds.json"), "--checkpoint_dir", str(ckpt),
              "--output_path", str(out), "--dev", "cpu"])
    for i in range(2):
        pred = tnifti.read_nifti(str(out / f"case_{i}_prob.nii.gz")).data
        assert pred.shape == (16, 16, 8)
        assert np.isfinite(pred).all()
        assert pred.min() >= 0.0 and pred.max() <= 1.0


UNETR_CONFIG = {
    "patch_size": [8, 8, 4], "embedding_size": 32, "number_of_blocks": 4,
    "n_heads": 4, "feature_size": 4, "dropout_rate": 0.1,
    "norm_type": "instance", "n_channels": 1, "learning_rate": 0.005,
    "batch_size": 1, "weight_decay": 0.0005,
    "loss_fn": {"dice": {"eps": 1.0e-6}, "focal": {"gamma": 0.0}},
}


def test_unetr_train_then_predict_on_cpu(cohort):
    """``--segmentation_net_type unetr`` with the keys of
    ``sample_configs/unetr.yaml`` at narrow widths (dropout on): the
    checkpoint records the net type, and predict rebuilds the UNETR from
    it for the volume size it was trained at."""
    import yaml

    # YAML proper: PyYAML reads JSON's "1e-06" as a string
    (cohort / "unetr.yaml").write_text(yaml.safe_dump(UNETR_CONFIG))
    ckpt = cohort / "ckpt_unetr"
    args = _train_args(cohort, ckpt, "--dev", "cpu",
                       "--segmentation_net_type", "unetr")
    args[args.index("--config_file") + 1] = str(cohort / "unetr.yaml")
    cli_main(["segmentation", "train", *args])
    fold = ckpt / "segmentation_fold0"
    meta = json.loads((fold / "metadata.json").read_text())
    assert meta["net_type"] == "unetr"
    assert meta["network_config"]["patch_size"] == [8, 8, 4]
    state = torch.load(fold / "model.pt", weights_only=True)
    assert "LinearEmbedding_0.pos_embedding" in state
    assert tuple(state["LinearEmbedding_0.pos_embedding"].shape) == (1, 8, 32)
    assert all(bool(torch.isfinite(v).all()) for v in state.values())
    with open(ckpt / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert {r["metric"] for r in rows} >= {"loss", "dice", "val_loss"}

    out = cohort / "pred_unetr"
    cli_main(["segmentation", "predict", "--dataset_json",
              str(cohort / "ds.json"), "--checkpoint_dir", str(ckpt),
              "--output_path", str(out), "--dev", "cpu"])
    for i in range(2):
        pred = tnifti.read_nifti(str(out / f"case_{i}_prob.nii.gz")).data
        assert pred.shape == (16, 16, 8)
        assert np.isfinite(pred).all()
        assert pred.min() >= 0.0 and pred.max() <= 1.0


def test_unetr_random_crops_raise(cohort):
    """UNETR's positional embedding fixes its input size, and predict,
    test and whole-volume validation run it at ``--pad_size``: crops
    smaller than the volume are refused before anything is built."""
    (cohort / "unetr_crop.yaml").write_text(json.dumps(UNETR_CONFIG))
    ckpt = cohort / "ckpt_unetr_crop"
    args = _train_args(cohort, ckpt, "--dev", "cpu",
                       "--segmentation_net_type", "unetr",
                       "--random_crop_size", "8", "8", "8")
    args[args.index("--config_file") + 1] = str(cohort / "unetr_crop.yaml")
    with pytest.raises(NotImplementedError,
                       match="unet and swin net types only"):
        ttrain.main(args)
    assert not (ckpt / "segmentation_fold0").exists()


def test_train_unknown_net_type_raises(cohort):
    with pytest.raises(NotImplementedError, match="unetr"):
        ttrain.main(_train_args(cohort, cohort / "ckpt_y", "--dev", "cpu",
                                "--segmentation_net_type", "unetpp"))


def test_train_dev_defaults_to_cuda(cohort, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--dev cpu"):
        ttrain.main(_train_args(cohort, cohort / "ckpt_cuda"))


@pytest.mark.parametrize("flags", [["--logger_type", "wandb"]])
def test_train_logger_flags(cohort, flags, monkeypatch, tmp_path):
    """The experiment logger flag: both CLIs build their metric logger
    with the same arguments, with which both packages' loggers write the
    same CSV and give the same warning (wandb is not installed)."""

    def run(tag, flags):
        # both stop before anything is written
        args = _train_args(cohort, tmp_path / "ckpt", "--dev", "cpu",
                           *flags)
        if tag == "jax":
            jax_main(["segmentation", "train", *args])
        else:
            ttrain.main(args)

    seen = logger_arguments(monkeypatch, jtrain, flags, run)
    assert seen["port"] == seen["jax"]
    _, warned = compare_loggers(seen["port"], tmp_path)
    assert warned == ["wandb not installed; falling back to CSV only"]


@pytest.mark.parametrize(
    "flags",
    [["--remat"], ["--semi_supervised"],
     ["--missing_to_empty", "mask"],
     ["--skip_keys", "T2"], ["--optimizer", "lamb"],
     ["--delete_checkpoints"]],
)
def test_train_unported_flags_raise(cohort, flags):
    with pytest.raises(NotImplementedError):
        ttrain.main(_train_args(cohort, cohort / "ckpt_x", "--dev", "cpu",
                                *flags))
