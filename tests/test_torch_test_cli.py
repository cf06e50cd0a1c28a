"""
The port's ``segmentation test`` against the JAX package's, and the
port's training options end to end, on the CPU.

One tiny cohort (16^3 volumes with blob lesions) and one small U-Net
(widths 4, 8, 16): the JAX checkpoint is written with the JAX
``CheckpointManager`` and the same weights through ``from_flax`` into the
port's; both ``segmentation test`` CLIs (``--dev cpu``, with and without
``--picai_eval``, binary and three-class) print JSON that agrees within
1e-4. Then the port's train CLI with pos/neg crops, ``--swa``,
``--early_stopping``, ``--check_nan_loss``, ``--sliding_window_val`` and
``--picai_eval`` runs 2 epochs, resumes for a third, and skips the
finished fold; ``predict --extract_lesions`` and
``test_from_predictions`` run on what it wrote.
"""

import csv
import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.__main__ import main as jax_main
from adell_mri_tpu.eval.lesion import extract_lesion_candidates as jextract
from adell_mri_tpu.models.segmentation.unet import UNet as JaxUNet
from adell_mri_tpu.train.checkpoints import CheckpointManager as JaxCkpt
from adell_mri_torch.__main__ import main as cli_main
from adell_mri_torch.data import nifti as tnifti
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.train.checkpoints import CheckpointManager
from test_torch_unet import FLAGSHIP_SMALL, random_flax_params

LPS = np.diag([-1.0, -1.0, 1.0, 1.0])
SHAPE = (16, 16, 16)
TOL = 1e-4


def _blob_case(rng):
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in SHAPE],
                                indexing="ij"), -1)
    mask = np.zeros(SHAPE, np.float32)
    for _ in range(rng.integers(1, 3)):
        c = rng.uniform(3, 13, 3)
        mask[((grid - c) ** 2).sum(-1) <= rng.uniform(2.0, 3.5) ** 2] = 1.0
    img = 1.0 + 2.0 * mask + 0.3 * rng.normal(size=SHAPE)
    return img.astype(np.float32), mask


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("test_cohort")
    rng = np.random.default_rng(0)
    ds = {}
    for i in range(4):
        img, mask = _blob_case(rng)
        paths = {}
        for key, data in (("T2", img), ("mask", mask)):
            paths[key] = str(root / f"case_{i}_{key}.nii.gz")
            tnifti.write_nifti(paths[key], data, LPS)
        ds[f"case_{i}"] = paths
    (root / "ds.json").write_text(json.dumps(ds))
    return root


def _checkpoints(root, n_classes):
    """The same seeded weights as a JAX checkpoint and a port one."""
    cfg = {k: list(v) if isinstance(v, tuple) else v
           for k, v in FLAGSHIP_SMALL.items() if k != "n_classes"}
    metadata = {
        "network_config": cfg,
        "transform_arguments": {
            "image_keys": ["T2"], "label_keys": ["mask"],
            "target_spacing": [1.0, 1.0, 1.0],
            "target_size": list(SHAPE), "adc_keys": [],
            "positive_labels": [1],
        },
        "n_classes": n_classes,
        "net_type": "unet",
    }
    jm = JaxUNet(**{**FLAGSHIP_SMALL, "n_classes": n_classes})
    params = random_flax_params(jm, jnp.zeros((1,) + SHAPE + (1,)),
                                seed=20 + n_classes)
    jdir = root / f"jax_ckpt_{n_classes}"
    jck = JaxCkpt(str(jdir), name="segmentation", fold=0, metadata=metadata)
    jck.save(1, {"params": params}, metrics={"val_loss": 0.5})
    jck.wait()
    tdir = root / f"torch_ckpt_{n_classes}"
    CheckpointManager(str(tdir), name="segmentation", fold=0,
                      metadata=metadata).save(from_flax(params), step=1,
                                              value=0.5)
    return jdir, tdir


def _last_json(out: str):
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


@pytest.mark.parametrize("n_classes", [2, 3])
@pytest.mark.parametrize("picai", [False, True])
def test_test_cli_matches_jax(cohort, capsys, n_classes, picai):
    jdir, tdir = _checkpoints(cohort, n_classes)
    common = ["--dataset_json", str(cohort / "ds.json"), "--dev", "cpu"]
    if picai:
        common.append("--picai_eval")
    jax_main(["segmentation", "test", *common, "--checkpoint_dir",
              str(jdir), "--metric_path", str(cohort / "m_jax.csv")])
    want = _last_json(capsys.readouterr().out)
    cli_main(["segmentation", "test", *common, "--checkpoint_dir",
              str(tdir), "--metric_path", str(cohort / "m_torch.csv")])
    got = _last_json(capsys.readouterr().out)
    assert set(got) == set(want)
    assert got["n_cases"] == want["n_cases"] == 4
    for k, v in want.items():
        if isinstance(v, float) and np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - v) <= TOL, (k, got[k], v)
    if picai:
        assert {"AP", "auroc", "score"} <= set(got)


def test_test_cli_bf16_returns_f32_metrics(cohort, capsys):
    """``--precision bf16`` runs and scores within bf16's reach of f32."""
    _, tdir = _checkpoints(cohort, 2)
    args = ["segmentation", "test", "--dataset_json", str(cohort / "ds.json"),
            "--dev", "cpu", "--checkpoint_dir", str(tdir), "--metric_path",
            str(cohort / "m_bf16.csv")]
    cli_main(args)
    f32 = _last_json(capsys.readouterr().out)
    cli_main(args + ["--precision", "bf16"])
    bf16 = _last_json(capsys.readouterr().out)
    # bf16 flips probabilities near 0.5 only: 5e-2, as for probabilities
    assert abs(bf16["dice"] - f32["dice"]) <= 5e-2
    assert abs(bf16["iou"] - f32["iou"]) <= 5e-2


CONFIG = {
    "spatial_dimensions": 3, "conv_type": "regular",
    "link_type": "residual", "upscale_type": "transpose",
    "norm_type": "instance", "activation_fn": "swish", "depth": [4, 8, 16],
    "kernel_sizes": [3, 3, 3], "strides": [2, 2, 2], "learning_rate": 0.01,
    "loss_fn": {"dice": {}, "focal": {"gamma": 1.0}},
}


def _train(cohort, ckpt, *extra):
    cli_main([
        "segmentation", "train", "--dataset_json", str(cohort / "ds.json"),
        "--image_keys", "T2", "--mask_keys", "mask", "--config_file",
        str(cohort / "unet.json"), "--pad_size", "16", "16", "16",
        "--random_crop_size", "8", "8", "8", "--target_spacing", "1", "1",
        "1", "--batch_size", "2", "--n_folds", "1", "--augment",
        "intensity", "noise", "affine", "flip", "--swa",
        "--early_stopping", "5", "--check_nan_loss", "--sliding_window_val",
        "--picai_eval", "--dev", "cpu", "--checkpoint_dir", str(ckpt),
        "--metric_path", str(ckpt / "metrics.csv"), *extra,
    ])


def test_train_options_resume_and_serve(cohort, capsys, caplog):
    (cohort / "unet.json").write_text(json.dumps(CONFIG))
    ckpt = cohort / "ckpt_options"
    _train(cohort, ckpt, "--max_epochs", "2")
    fold = ckpt / "segmentation_fold0"
    last = torch.load(fold / "last.pt", weights_only=True)
    assert last["epoch"] == 2 and last["step"] == 2
    assert last["ema_params"] is not None
    with open(ckpt / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    names = {r["metric"] for r in rows}
    assert {"loss", "val_loss", "val_dice", "V_AP"} <= names
    assert {r["step"] for r in rows if r["metric"] == "val_loss"} == {
        "0", "1"}

    with caplog.at_level(logging.INFO, logger="adell_mri_torch"):
        _train(cohort, ckpt, "--max_epochs", "3", "--resume_from_last")
    assert "fold 0: resuming from epoch 2" in caplog.text
    last = torch.load(fold / "last.pt", weights_only=True)
    assert last["epoch"] == 3 and last["step"] == 3
    assert last["schedule_step"] == 3
    with open(ckpt / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert {r["step"] for r in rows if r["metric"] == "val_loss"} == {
        "0", "1", "2"}

    caplog.clear()
    with caplog.at_level(logging.INFO, logger="adell_mri_torch"):
        _train(cohort, ckpt, "--max_epochs", "3", "--resume_from_last")
    assert "fold 0 already finished; skipping" in caplog.text

    # the checkpoint serves: test, predict --extract_lesions, and
    # test_from_predictions on the written maps
    capsys.readouterr()
    cli_main(["segmentation", "test", "--dataset_json",
              str(cohort / "ds.json"), "--checkpoint_dir", str(ckpt),
              "--dev", "cpu", "--picai_eval", "--metric_path",
              str(ckpt / "test.csv")])
    res = _last_json(capsys.readouterr().out)
    assert res["n_cases"] == 4 and 0.0 <= res["dice"] <= 1.0
    out = cohort / "pred_lesions"
    cli_main(["segmentation", "predict", "--dataset_json",
              str(cohort / "ds.json"), "--checkpoint_dir", str(ckpt),
              "--output_path", str(out), "--dev", "cpu",
              "--extract_lesions", "--prediction_ids", "case_0"])
    cand = tnifti.read_nifti(str(out / "case_0_prob.nii.gz")).data
    probs = cohort / "pred_probs"
    cli_main(["segmentation", "predict", "--dataset_json",
              str(cohort / "ds.json"), "--checkpoint_dir", str(ckpt),
              "--output_path", str(probs), "--dev", "cpu",
              "--prediction_ids", "case_0"])
    prob = tnifti.read_nifti(str(probs / "case_0_prob.nii.gz")).data
    # the candidate map is the JAX extraction of the probability map
    # (1e-6: the map went through a NIfTI write and read)
    np.testing.assert_allclose(
        cand, jextract(prob, threshold="dynamic")[0], atol=1e-6)

    ds = json.loads((cohort / "ds.json").read_text())
    ds["case_0"]["pred"] = str(probs / "case_0_prob.nii.gz")
    (cohort / "ds_pred.json").write_text(json.dumps(ds))
    capsys.readouterr()
    cli_main(["segmentation", "test_from_predictions", "--dataset_json",
              str(cohort / "ds_pred.json"), "--ground_truth_key", "mask",
              "--prediction_key", "pred", "--prediction_mode", "probs",
              "--picai_eval"])
    agg = _last_json(capsys.readouterr().out)
    label = tnifti.reorient_to_ras(tnifti.read_nifti(ds["case_0"]["mask"]))
    p = tnifti.reorient_to_ras(tnifti.read_nifti(ds["case_0"]["pred"]))
    t = label.data > 0.5
    h = p.data > 0.5
    want = 1.0 if t.sum() + h.sum() == 0 else 2 * (t & h).sum() / (
        t.sum() + h.sum())
    assert abs(agg["dice"] - want) <= 1e-9
    assert {"lesion_AP", "lesion_auroc", "lesion_score"} <= set(agg)
    assert os.path.exists(fold / "model.pt")
