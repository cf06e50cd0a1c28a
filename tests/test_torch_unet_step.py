"""
The U-Net's batch-norm training step and the option space through the
segmentation CLI, on the CPU.

- ``make_segmentation_step`` with ``norm_type: batch`` against the JAX
  step on the same weights, statistics and batch (dropout 0): the loss
  within 1e-5 relative, the updated running statistics within 1e-5
  (``metrics["_variables"]``); the train step carries them into the
  state, an eval forward normalizes by them (1e-4 of the logits' scale
  against the JAX forward on the JAX step's statistics); a bf16 step
  keeps them f32.
- ``segmentation train``, ``predict``, ``test`` (and, on the resnet
  net's files, ``test_from_predictions``) with ``--dev cpu`` on
  a 2-case 16x16x8 cohort: ``sample_configs/u-net-3d-resnet.yaml`` as it
  stands (five levels, widths 32 to 256), and a yaml without
  ``link_type`` and ``upscale_type`` (the CLI's defaults: identity links,
  upsample) with batch norm, prelu and uout, whose checkpoint carries the
  running statistics.
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from adell_mri_tpu.config import parsing as jparsing
from adell_mri_tpu.models.segmentation.unet import UNet as JaxUNet
from adell_mri_tpu.train import steps as jsteps
from adell_mri_torch.__main__ import main as cli_main
from adell_mri_torch.config import parsing as tparsing
from adell_mri_torch.data import nifti as tnifti
from adell_mri_torch.data.nifti import read_nifti
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.segmentation.unet import UNet
from adell_mri_torch.train import steps as tsteps
from adell_mri_torch.train.optim import get_optimizer
from adell_mri_torch.train.state import TrainState
from test_torch_unet_options import BASE, random_variables

ROOT = Path(__file__).resolve().parents[1]
BATCH_NORM = dict(BASE, norm_type="batch", activation_fn="prelu",
                  conv_type="resnet", depth=(4, 8, 16))
LOSS = {"dice": {}, "focal": {"gamma": 1.0}}


def _batch(seed=0, shape=(2, 16, 16, 8)):
    rng = np.random.default_rng(seed)
    image = rng.normal(size=shape + (1,)).astype(np.float32)
    label = np.zeros(shape, np.float32)
    label[:, 4:10, 5:12, 2:6] = 1.0
    return image, label


@pytest.fixture(scope="module")
def stepped():
    """One JAX training step and one port step from the same weights,
    statistics and batch."""
    image, label = _batch()
    jm = JaxUNet(**BATCH_NORM)
    variables = random_variables(jm, jnp.asarray(image), seed=3)
    jlm = jsteps.make_segmentation_step(
        jm, jparsing.build_compound_loss(LOSS, 2), train=True)
    jloss, jmet = jax.jit(jlm)(
        variables["params"],
        {"image": jnp.asarray(image), "label": jnp.asarray(label)},
        jax.random.PRNGKey(0), {"batch_stats": variables["batch_stats"]})
    new_bs = jmet["_variables"]["batch_stats"]
    tm = UNet(**BATCH_NORM)
    tm.load_state_dict(from_flax(variables["params"],
                                 variables["batch_stats"]))
    tlm = tsteps.make_segmentation_step(
        tm, tparsing.build_compound_loss(LOSS, 2), train=True)
    state = TrainState.create(
        tm, lambda p: get_optimizer("sgd", 1e-3, params=p))
    batch = {"image": torch.from_numpy(image),
             "label": torch.from_numpy(label)}
    tloss, tmet = tlm(state.weights(), batch)
    return dict(jm=jm, variables=variables, jloss=float(jloss),
                new_bs=new_bs, tm=tm, tlm=tlm, state=state, batch=batch,
                tloss=float(tloss), tmet=tmet, image=image)


def test_batch_norm_step_matches_jax(stepped):
    assert abs(stepped["tloss"] - stepped["jloss"]) <= 1e-5 * abs(
        stepped["jloss"])
    want = from_flax({}, stepped["new_bs"])
    got = stepped["tmet"]["_variables"]
    assert set(got) == set(want) and len(want) > 20
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        err = float((got[k] - v).abs().max())
        assert err <= 1e-5 * max(1.0, float(v.abs().max())), (k, err)


def test_train_step_carries_statistics_and_eval_uses_them(stepped):
    """The train step writes the statistics into the state (``model.pt``
    and ``last.pt`` save ``state.state_dict()``); an eval forward on
    ``state.weights()`` equals the JAX eval forward on the JAX step's
    statistics."""
    state = stepped["state"]
    train_step = tsteps.make_train_step(stepped["tlm"])
    state, metrics = train_step(state, stepped["batch"])
    assert "_variables" not in metrics
    want = from_flax({}, stepped["new_bs"])
    for k, v in want.items():
        assert torch.allclose(state.variables[k], v, atol=1e-5), k
        assert k in state.state_dict()
    # the JAX eval forward on the step's statistics and the updated weights
    params = jax.tree.map(np.asarray, stepped["variables"]["params"])
    # the state's parameters are the model's own: keep a copy
    weights = {k: v.detach().clone() for k, v in state.weights().items()}
    tm = stepped["tm"]
    x = torch.from_numpy(stepped["image"])
    with torch.no_grad():
        got = torch.func.functional_call(
            tm.eval(), weights, (x,), {"return_logits": True})
        tm.load_state_dict({**from_flax(params, stepped["new_bs"])})
        on_jax_stats = tm(x, return_logits=True)
        tm.load_state_dict(weights)
        again = tm(x, return_logits=True)
    assert torch.equal(got, again)
    want_logits = np.asarray(stepped["jm"].apply(
        {"params": stepped["variables"]["params"],
         "batch_stats": stepped["new_bs"]},
        jnp.asarray(stepped["image"]), return_logits=True)[0])
    scale = np.abs(want_logits).max()
    assert np.abs(on_jax_stats.numpy() - want_logits).max() <= 1e-4 * scale


def test_bf16_step_keeps_statistics_f32(stepped):
    """The bf16 step's statistics are f32 and near the f32 step's on the
    same weights, within 1e-2 of the layer's scale (bf16 activations move
    a batch statistic by a few bf16 steps; 4.7e-4 at the worst here)."""
    tm = stepped["tm"]
    lm = tsteps.make_segmentation_step(
        tm, tparsing.build_compound_loss(LOSS, 2), train=True,
        precision="bf16")
    weights = stepped["state"].weights()
    loss, metrics = lm(weights, stepped["batch"])
    assert torch.isfinite(loss)
    stats = metrics["_variables"]
    assert stats and all(v.dtype == torch.float32 for v in stats.values())
    assert all(v.dtype == torch.float32 for v in weights.values())
    want = stepped["tlm"](weights, stepped["batch"])[1]["_variables"]
    assert set(stats) == set(want)
    for k, v in want.items():
        err = float((stats[k] - v).abs().max())
        assert err <= 1e-2 * max(1.0, float(v.abs().max())), k


# -- the CLI -----------------------------------------------------------------------

LPS = np.diag([-1.0, -1.0, 2.0, 1.0])


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("unet_options_cohort")
    rng = np.random.default_rng(0)
    ds = {}
    for i in range(2):
        mask = np.zeros((16, 16, 8), np.float32)
        mask[4:10, 5:12, 2:6] = 1.0
        img = (rng.normal(size=(16, 16, 8)) + 2 * mask).astype(np.float32)
        paths = {}
        for key, data in (("T2", img), ("mask", mask)):
            paths[key] = str(root / f"case_{i}_{key}.nii.gz")
            tnifti.write_nifti(paths[key], data, LPS)
        ds[f"case_{i}"] = paths
    (root / "ds.json").write_text(json.dumps(ds))
    shutil.copy(ROOT / "sample_configs" / "u-net-3d-resnet.yaml",
                root / "resnet.yaml")
    defaults = {k: v for k, v in yaml.safe_load(
        (ROOT / "sample_configs" / "u-net-3d-resnet.yaml").read_text()
    ).items() if k not in ("link_type", "upscale_type")}
    defaults.update(conv_type="regular", norm_type="batch",
                    activation_fn="prelu", dropout_type="uout",
                    depth=[4, 8, 16], kernel_sizes=[3, 3, 3],
                    strides=[2, 2, 2])
    (root / "defaults.yaml").write_text(yaml.safe_dump(defaults))
    return root


def _run(root, config, tag):
    ckpt = root / f"ckpt_{tag}"
    cli_main([
        "segmentation", "train", "--dataset_json", str(root / "ds.json"),
        "--image_keys", "T2", "--mask_keys", "mask", "--config_file",
        str(root / config), "--pad_size", "16", "16", "8",
        "--target_spacing", "1", "1", "2", "--batch_size", "1",
        "--max_epochs", "1", "--n_folds", "1", "--augment", "intensity",
        "noise", "affine", "flip", "--dev", "cpu", "--checkpoint_dir",
        str(ckpt), "--metric_path", str(ckpt / "metrics.csv")])
    fold = ckpt / "segmentation_fold0"
    meta = json.loads((fold / "metadata.json").read_text())
    pred = root / f"pred_{tag}"
    cli_main(["segmentation", "predict", "--dataset_json",
              str(root / "ds.json"), "--checkpoint_dir", str(ckpt),
              "--output_path", str(pred), "--dev", "cpu"])
    for pid in ("case_0", "case_1"):
        prob = read_nifti(str(pred / f"{pid}_prob.nii.gz")).data
        assert prob.shape == (16, 16, 8) and np.isfinite(prob).all()
        assert 0 <= prob.min() and prob.max() <= 1
    return ckpt, fold, meta


def test_resnet_yaml_train_predict_test_on_cpu(cohort, capsys):
    ckpt, fold, meta = _run(cohort, "resnet.yaml", "resnet")
    assert meta["network_config"]["conv_type"] == "resnet"
    assert meta["network_config"]["depth"] == [32, 32, 64, 128, 256]
    state = torch.load(fold / "model.pt", weights_only=True)
    assert "enc_ds_2.ResidualBlock_0.Conv_3" not in {
        k.rsplit(".", 1)[0] for k in state}
    assert state["enc_ds_2.ResidualBlock_0.Conv_0.weight"].shape == (64, 64)
    capsys.readouterr()
    cli_main(["segmentation", "test", "--dataset_json",
              str(cohort / "ds.json"), "--checkpoint_dir", str(ckpt),
              "--dev", "cpu", "--metric_path", str(ckpt / "test.csv")])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["n_cases"] == 2 and 0 <= result["dice"] <= 1
    ds = json.loads((cohort / "ds.json").read_text())
    pred_ds = {pid: {**entry, "pred": str(
        cohort / "pred_resnet" / f"{pid}_prob.nii.gz")}
        for pid, entry in ds.items()}
    (cohort / "ds_pred.json").write_text(json.dumps(pred_ds))
    cli_main(["segmentation", "test_from_predictions", "--dataset_json",
              str(cohort / "ds_pred.json"), "--ground_truth_key", "mask",
              "--prediction_key", "pred", "--prediction_mode", "probs"])
    scored = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert 0 <= scored["dice"] <= 1


def test_cli_defaults_with_batch_norm_train_and_serve(cohort, capsys):
    """The yaml lacks ``link_type`` and ``upscale_type``: the factory's
    defaults (identity, upsample) build the net, as in the JAX CLI; its
    batch norms' running statistics move in training and are saved."""
    ckpt, fold, meta = _run(cohort, "defaults.yaml", "defaults")
    assert "link_type" not in meta["network_config"]
    state = torch.load(fold / "model.pt", weights_only=True)
    means = [k for k in state if k.endswith(".mean")]
    assert means and any(float(state[k].abs().max()) > 0 for k in means)
    assert not any(k.startswith("link_") for k in state)
    assert state["up_0.weight"].shape == (8, 16)
    last = torch.load(fold / "last.pt", weights_only=True)
    assert set(last["variables"]) == {
        k for k in state if k.endswith((".mean", ".var"))}
    capsys.readouterr()
    cli_main(["segmentation", "test", "--dataset_json",
              str(cohort / "ds.json"), "--checkpoint_dir", str(ckpt),
              "--dev", "cpu", "--metric_path", str(ckpt / "test.csv")])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["n_cases"] == 2
