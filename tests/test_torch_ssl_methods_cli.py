"""
The port's ``ssl`` entry points for VICRegL, DINO, iBOT and MAE on the
CPU, beside the JAX CLIs.

``ssl train --dev cpu`` trains each method an epoch on
``tests/test_torch_ssl_cli.py``'s 4-case 20x20x10 cohort (DINO with
``--n_local_crops 2``; the ViTs at a tiny width): DINO and iBOT keep an
EMA shadow and their centres, which the checkpoint holds and
``--resume_from_last`` restores; VICRegL leaves the running statistics
as they were, as the JAX step applies the parameters alone; MAE reads the
base-size image. ``predict_folder`` and ``model_to_export`` on a JAX
checkpoint of each method (the JAX CLI's initialisation, saved as its
trainer saves it) and on the port's copy through ``from_flax``: VICRegL's
features within 1.5e-4 of the JAX CLI's (4-decimal rounding); DINO's and
iBOT's artifacts give the JAX artifacts' output within 1e-5 of its scale,
with the same sidecar; where the JAX CLI fails (``predict_folder`` on
DINO, iBOT and MAE: a ``TypeError`` on ``ret``; ``model_to_export`` of
MAE: ``InvalidRngError``) the port refuses with ``NotImplementedError``,
and so it does for the JAX exporter's VICRegL artifact, which ends in a
prediction head the checkpoint does not hold (drawn from ``PRNGKey(0)``,
so its width is the prediction head's).
"""

import csv
import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from adell_mri_tpu.__main__ import main as jax_main
from adell_mri_tpu.config.factories import get_ssl_network as jget_ssl_network
from adell_mri_tpu.train.checkpoints import CheckpointManager as JaxCkpt
from adell_mri_tpu.train.export import load_exported as jload_exported
from adell_mri_torch.__main__ import main as cli_main
from adell_mri_torch.config.factories import get_ssl_network
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.train.checkpoints import CheckpointManager
from adell_mri_torch.train.export import load_exported
from adell_mri_torch.train.optim import get_optimizer
from adell_mri_torch.train.ssl_steps import initial_centres
from adell_mri_torch.train.state import TrainState
from test_torch_classification import _close
from test_torch_ssl_methods import _draw_params
from test_torch_ssl_cli import CROP, N_CASES, NETWORK, SHAPE, _train_args
from test_torch_ssl_cli import cohort  # noqa: F401  (the shared fixture)

VIT_YAML = {"patch_size": [4, 4, 2], "embed_dim": 16, "n_blocks": 1,
            "n_heads": 2, "out_dim": 32, "hidden_dim": 24,
            "bottleneck_dim": 8, "decoder_dim": 8, "decoder_blocks": 1,
            "batch_size": 2, "learning_rate": 0.01, "weight_decay": 0.001}
# one stage of the CLI tests' backbone (the JAX CLIs' eager flax inits
# take seconds a stage), and a prediction head narrower than the
# projection, so that the JAX exporter's appended head shows in its
# output's width
VICREGL_NET = {
    **NETWORK,
    "backbone_args": {**NETWORK["backbone_args"],
                      "structure": [[8, 16, 3, 1]],
                      "maxpool_structure": [[2, 2, 2]]},
    "prediction_head_args": {"in_channels": 16, "structure": [24, 12]}}
CENTRES = {"dino": ("dino_center",),
           "ibot": ("ibot_center_global", "ibot_center_mask")}


@pytest.fixture(scope="module")
def configs(cohort):  # noqa: F811
    (cohort / "vit.yaml").write_text(yaml.safe_dump(VIT_YAML))
    (cohort / "vicregl.yaml").write_text(yaml.safe_dump(VICREGL_NET))
    return cohort


def _config(method):
    return "vicregl.yaml" if method == "vicregl" else "vit.yaml"


@pytest.mark.parametrize("method, extra", [
    ("dino", ["--n_local_crops", "2", "--random_crop_size",
              *map(str, CROP)]),
    ("ibot", ["--random_crop_size", *map(str, CROP)]),
    ("mae", []),
    ("vicregl", ["--random_crop_size", *map(str, CROP)]),
])
def test_new_method_trains_and_resumes(configs, method, extra):
    """An epoch of 2 steps: finite losses (VICRegL's components and its
    local term, iBOT's two terms), the EMA shadow for DINO and iBOT, their
    centres moved from 0 and kept in ``last.pt``, which a resume puts back
    into a fresh state; VICRegL's running statistics still the initial
    (0, 1); then ``--resume_from_last`` trains a second epoch."""
    root = configs
    ckpt = root / f"ckpt_{method}"
    args = _train_args(root, ckpt, "--ssl_method", method, "--max_epochs",
                       "1", *extra, config=_config(method))
    cli_main(["ssl", "train", *args])
    fold = ckpt / f"ssl_{method}_fold0"
    meta = json.loads((fold / "metadata.json").read_text())
    assert meta["ssl_method"] == method
    with open(ckpt / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    names = {r["metric"] for r in rows}
    want = {"vicregl": {"local", "invariance", "variance", "covariance"},
            "ibot": {"loss_global", "loss_mask"}}.get(method, set())
    assert {"loss"} | want <= names
    assert all(np.isfinite(float(r["value"])) for r in rows)
    last = torch.load(fold / "last.pt", weights_only=True)
    assert last["step"] == N_CASES // 2
    assert (last["ema_params"] is not None) == (method in CENTRES)
    centres = {k: last["variables"][k] for k in CENTRES.get(method, ())}
    assert all(float(v.abs().max()) > 0 for v in centres.values())
    if method == "vicregl":
        stats = last["variables"]
        assert stats and all(
            torch.equal(v, torch.zeros_like(v) if k.endswith(".mean")
                        else torch.ones_like(v)) for k, v in stats.items())
    model = get_ssl_network(method, VICREGL_NET if method == "vicregl"
                            else VIT_YAML, image_size=CROP)
    state = TrainState.create(model, lambda p: get_optimizer(
        "adamw", 0.01, weight_decay=1e-3, params=p,
        exclude_norms_from_decay=True, model=model),
        with_ema=method in CENTRES)
    state.variables.update(initial_centres(method, 32))
    state, epoch = CheckpointManager(str(ckpt), name=f"ssl_{method}",
                                     fold=0).resume(state)
    assert epoch == 1
    for k, v in centres.items():
        assert torch.equal(state.variables[k], v)
    cli_main(["ssl", "train", *args[:-len(extra) or None],
              "--max_epochs", "2", *extra, "--resume_from_last"])
    assert torch.load(fold / "last.pt", weights_only=True)["step"] == (
        2 * (N_CASES // 2))


def _jax_checkpoints(root, method):
    """A JAX checkpoint of ``method`` (the JAX CLI's initialisation, saved
    with its variables: batch statistics, centres) and the port's copy
    through ``from_flax`` (the centres beside the weights)."""
    cfg = VICREGL_NET if method == "vicregl" else VIT_YAML
    meta = {"network_config": cfg, "ssl_method": method,
            "transform_arguments": {"image_keys": ["image"],
                                    "target_size": list(SHAPE),
                                    "target_spacing": [1.0, 1.0, 2.0]}}
    jm = jget_ssl_network(method, cfg)
    x0 = np.zeros((1,) + SHAPE + (1,), np.float32)
    rngs = {"params": jax.random.PRNGKey(3), "masking": jax.random.PRNGKey(4)}
    kw = {"vicregl": dict(ret="local"), "ibot": dict(mask=True),
          "mae": dict(rng=jax.random.PRNGKey(0))}.get(method, {})
    # drawn from numpy on eval_shape's tree: an eager or jitted flax init
    # of the CatNet takes seconds; batch statistics (0, 1) as init's
    shapes = jax.eval_shape(lambda r, x: jm.init(r, x, **kw), rngs, x0)
    init = {"params": _draw_params(shapes["params"], 3), **{
        k: jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.full(a.shape, float(path[-1].key == "var"),
                                     a.dtype), v)
        for k, v in shapes.items() if k != "params"}}
    variables = {k: v for k, v in init.items() if k != "params"}
    rng = np.random.default_rng(5)
    for k in CENTRES.get(method, ()):
        variables[k] = jnp.asarray(rng.normal(size=32).astype(np.float32))
    jdir, tdir = root / f"jax_{method}", root / f"torch_{method}"
    jck = JaxCkpt(str(jdir), name=f"ssl_{method}", fold=0, metadata=meta)
    jck.save(1, {"params": init["params"], "step": 1,
                 **({"variables": variables} if variables else {})},
             metrics={})
    jck.wait()
    state = from_flax(init["params"], variables.get("batch_stats"))
    state.update({k: torch.from_numpy(np.asarray(variables[k]))
                  for k in CENTRES.get(method, ())})
    CheckpointManager(str(tdir), name=f"ssl_{method}", fold=0,
                      metadata=meta).save(state)
    return jdir, tdir


@pytest.fixture(scope="module")
def jax_checkpoints(configs):
    """``_jax_checkpoints`` of a method, made once a module for the
    ``predict_folder`` and ``model_to_export`` tests."""
    made = {}

    def get(method):
        if method not in made:
            made[method] = _jax_checkpoints(configs, method)
        return made[method]
    return get


@pytest.mark.parametrize("method", ["vicregl", "dino", "ibot", "mae"])
def test_new_method_predict_folder_as_jax(configs, jax_checkpoints,
                                          method):
    """VICRegL: both CLIs' features within 1.5e-4; DINO, iBOT and MAE:
    the JAX CLI fails on ``ret``, the port refuses."""
    root = configs
    jdir, tdir = jax_checkpoints(method)
    jout = root / f"jax_{method}.json"
    tout = root / f"torch_{method}.json"
    common = ["--input_folder", str(root / "folder"), "--dev", "cpu",
              "--ssl_method", method]
    jargs = ["ssl", "predict_folder", "--checkpoint_dir", str(jdir),
             "--output_path", str(jout), *common]
    targs = ["ssl", "predict_folder", "--checkpoint_dir", str(tdir),
             "--output_path", str(tout), *common]
    if method != "vicregl":
        with pytest.raises(TypeError, match="ret"):
            jax_main(jargs)
        with pytest.raises(NotImplementedError, match="ret="):
            cli_main(targs)
        return
    jax_main(jargs)
    cli_main(targs)
    want, got = json.loads(jout.read_text()), json.loads(tout.read_text())
    assert sorted(got) == sorted(want) and len(got) == N_CASES
    for name, v in want.items():
        assert len(got[name]["features"]) == len(v["features"]) == 8
        np.testing.assert_allclose(got[name]["features"], v["features"],
                                   atol=1.5e-4, rtol=0)


@pytest.mark.parametrize("method", ["vicregl", "dino", "ibot", "mae"])
def test_new_method_model_to_export_as_jax(jax_checkpoints, method,
                                           tmp_path):
    """DINO and iBOT (B=2): the same sidecar and the port's artifact within
    1e-5 of the JAX artifact's output; VICRegL: the JAX artifact ends in
    a prediction head the checkpoint does not hold (12 wide, where the
    checkpoint's projection is 16), and the port refuses; MAE: the JAX
    exporter fails without its masking stream, the port refuses."""
    jdir, tdir = jax_checkpoints(method)
    jpath, tpath = tmp_path / "jax.bin", tmp_path / "port.pt2"
    jargs = ["ssl", "model_to_export", "--checkpoint_dir", str(jdir),
             "--output_path", str(jpath), "--batch_size", "2",
             "--ssl_method", method]
    targs = ["ssl", "model_to_export", "--checkpoint_dir", str(tdir),
             "--output_path", str(tpath), "--batch_size", "2",
             "--ssl_method", method, "--dev", "cpu"]
    if method == "mae":
        with pytest.raises(flax.errors.InvalidRngError, match="masking"):
            jax_main(jargs)
        with pytest.raises(NotImplementedError, match="MAE"):
            cli_main(targs)
        return
    jax_main(jargs)
    jfn, jmeta = jload_exported(str(jpath))
    x = np.random.default_rng(8).normal(size=(2, *SHAPE, 1)).astype(
        np.float32)
    want = np.asarray(jfn(x))
    if method == "vicregl":
        assert want.shape == (2, 12) and VICREGL_NET[
            "projection_head_args"]["structure"][-1] == 16
        with pytest.raises(NotImplementedError, match="Queue 3"):
            cli_main(targs)
        return
    cli_main(targs)
    tfn, tmeta = load_exported(str(tpath))
    assert tmeta == jmeta and tmeta["input_shape"] == [2, *SHAPE, 1]
    _close(tfn(torch.from_numpy(x)), want, 1e-5)
