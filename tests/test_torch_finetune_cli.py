"""
``segmentation train``'s fine-tuning flags, ``test --resize_size`` and
``predict --mc_iterations``, the port's against the JAX package's, on
the CPU.

One ``segmentation train`` on each side of a 5-case 16x16x8 cohort, from
the same initial weights (the JAX CLI's init, moved into the port's
network), with ``--res_config_file`` (a two-stage SSL yaml: the U-Net's
encoder is that ResNet backbone, batch norm, swish), ``--encoder_checkpoint``
(the same backbone weights: for the JAX CLI a checkpoint holding them
under ``ResNetBackbone_0``, for the port a checkpoint of its own
self-supervised network, whose backbone sits under
``backbone.ResNetBackbone_0``), ``--lr_encoder`` at a tenth of the rate,
``--freeze_regex encoder_backbone --not_freeze_regex ResidualBlock_1``,
``--accumulate_grad_batches 2`` (two micro-steps an epoch, one update)
over two epochs and ``--resize_size``. Dropout is 0 and nothing is
augmented, so the two trainings follow each other. Held:

- the metadata (the grafted encoder's keys, ``resize_size``);
- the weights each run kept within 1e-4 of each leaf's scale; the frozen
  encoder leaves bit-equal to the SSL checkpoint's; the moved encoder
  leaves (``ResidualBlock_1``) moved; the optimizer's update count 2;
- ``segmentation test`` of each run on its own checkpoint (the cases
  resized as in training) within 1e-4;
- the warm start's errors: a ``.pt`` reference checkpoint is refused
  naming ROADMAP Queue 1 item 10, a checkpoint of another structure
  matches no parameter and raises; the JAX CLI itself matches none on
  its own self-supervised checkpoint (ROADMAP Queue 3);
- MC dropout: ``SegmentationInference(mc_iterations=4)`` with dropout 0
  equal to the JAX one and to the deterministic path within 1e-5, and
  with dropout 0.5 the variance of the 16-draw mean over seeds about a
  sixteenth of one draw's (between a 32nd and an 8th); ``predict
  --mc_iterations 2`` runs through the CLI.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from adell_mri_tpu.config.factories import (
    get_segmentation_network as jget_network,
)
from adell_mri_tpu.entrypoints.segmentation import test as jtest
from adell_mri_tpu.entrypoints.segmentation import train as jtrain
from adell_mri_tpu.inference import SegmentationInference as JaxInference
from adell_mri_tpu.models.layers.adn import get_adn_fn as jget_adn_fn
from adell_mri_tpu.models.layers.res_net import (
    ResNetBackbone as JaxBackbone,
)
from adell_mri_tpu.models.segmentation.unet import UNet as JaxUNet
from adell_mri_tpu.train.checkpoints import CheckpointManager as JaxCkpt
from adell_mri_torch.config.factories import get_ssl_network
from adell_mri_torch.config.parsing import (
    parse_config_ssl,
    resnet_encoder_config,
)
from adell_mri_torch.data import nifti as tnifti
from adell_mri_torch.entrypoints.segmentation import predict as tpredict
from adell_mri_torch.entrypoints.segmentation import test as ttest
from adell_mri_torch.entrypoints.segmentation import train as ttrain
from adell_mri_torch.inference import SegmentationInference
from adell_mri_torch.interop.from_flax import flax_path, from_flax
from adell_mri_torch.models.layers.dropout import seed_dropout
from adell_mri_torch.models.segmentation.unet import UNet
from adell_mri_torch.train import checkpoints as tck
from adell_mri_torch.train.checkpoints import CheckpointManager
from adell_mri_torch.train.loop import TrainLoop
from test_torch_unet import FLAGSHIP_SMALL, random_flax_params
from test_torch_unet_options import random_variables

LPS = np.diag([-1.0, -1.0, 2.0, 1.0])
SHAPE = (16, 16, 8)
RESIZE = ["14", "14", "7"]
BACKBONE = {"structure": [[4, 4, 3, 1], [8, 8, 3, 1]],
            "maxpool_structure": [[2, 2, 1], [2, 2, 2]],
            "res_type": "resnet"}
SSL = {"backbone_args": BACKBONE, "norm_fn": "batch", "act_fn": "swish",
       "projection_head_args": {"structure": [16, 8]},
       "prediction_head_args": {"structure": [12, 8]}}
UNET = {"conv_type": "regular", "link_type": "identity",
        "upscale_type": "transpose", "norm_type": "batch",
        "activation_fn": "swish", "learning_rate": 0.05,
        "loss_fn": {"dice": {}, "focal": {"gamma": 1.0}}}
FROZEN, KEPT = "encoder_backbone", "ResidualBlock_1"
TOL = 1e-4


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("finetune_cohort")
    rng = np.random.default_rng(0)
    ds = {}
    for i in range(5):
        img = rng.normal(size=SHAPE).astype(np.float32)
        mask = np.zeros(SHAPE, np.float32)
        lo = rng.integers(2, 6, size=3)
        mask[lo[0]:lo[0] + 7, lo[1]:lo[1] + 6, 1:6] = 1.0
        img += 2.0 * mask
        paths = {}
        for key, data in (("T2", img), ("mask", mask)):
            paths[key] = str(root / f"case_{i}_{key}.nii.gz")
            tnifti.write_nifti(paths[key], data, LPS)
        ds[f"case_{i}"] = paths
    (root / "ds.json").write_text(json.dumps(ds))
    (root / "unet.yaml").write_text(yaml.safe_dump(UNET))
    (root / "ssl.yaml").write_text(yaml.safe_dump(SSL))
    return root


def _encoder_weights(root):
    """The backbone weights, drawn once: a JAX checkpoint holding them as
    a CatNet does (``ResNetBackbone_0``), one holding them as the JAX
    self-supervised wrapper does (``backbone/ResNetBackbone_0``), and a
    port checkpoint of its self-supervised network with them."""
    jb = JaxBackbone(structure=[tuple(s) for s in BACKBONE["structure"]],
                     maxpool_structure=[tuple(m) for m in
                                        BACKBONE["maxpool_structure"]],
                     adn_fn=jget_adn_fn(3, "batch", "swish"))
    tree = random_variables(jb, jnp.zeros((1,) + SHAPE + (1,)),
                            seed=7)["params"]
    for name, params in (("cat", {"ResNetBackbone_0": tree}),
                         ("ssl", {"backbone": {"ResNetBackbone_0": tree}})):
        ck = JaxCkpt(str(root / "jax_enc"), name=name, fold=0)
        ck.save(1, {"params": params}, metrics={"val_loss": 0.5})
        ck.wait()
    model = get_ssl_network("vicreg", parse_config_ssl(
        str(root / "ssl.yaml"))["network"])
    state = model.state_dict()
    for k, v in from_flax(tree).items():
        state[f"backbone.ResNetBackbone_0.{k}"] = v
    CheckpointManager(str(root / "torch_enc"), name="ssl", fold=0).save(
        state, step=1, value=0.5)
    return from_flax(tree)


def _args(root, ckpt, *extra):
    return [
        "--dataset_json", str(root / "ds.json"), "--image_keys", "T2",
        "--mask_keys", "mask", "--config_file", str(root / "unet.yaml"),
        "--pad_size", *map(str, SHAPE), "--target_spacing", "1", "1", "2",
        "--batch_size", "2", "--n_folds", "1", "--dev", "cpu",
        "--seed", "0", "--checkpoint_dir", str(ckpt),
        "--metric_path", str(ckpt / "metrics.csv"), *extra,
    ]


def _flags(root, encoder):
    return ["--max_epochs", "2", "--res_config_file", str(root / "ssl.yaml"),
            "--encoder_checkpoint", encoder, "--lr_encoder", "0.005",
            "--freeze_regex", FROZEN, "--not_freeze_regex", KEPT,
            "--accumulate_grad_batches", "2", "--resize_size", *RESIZE]


@pytest.fixture(scope="module")
def runs(cohort, monkeypatch_module):
    """Both sides' runs; returns their directories and what the port's
    optimizer counted."""
    encoder = _encoder_weights(cohort)
    net_cfg = dict(UNET)
    net_cfg.pop("learning_rate")
    net_cfg.pop("loss_fn")
    net_cfg.update(resnet_encoder_config(SSL))
    jm = jget_network("unet", net_cfg)
    init = jm.init({"params": jax.random.PRNGKey(0)},
                   np.zeros((1,) + SHAPE + (1,), np.float32))
    state = from_flax(init["params"], init["batch_stats"])
    build = ttrain.get_segmentation_network

    def from_jax_init(*args, **kwargs):
        model = build(*args, **kwargs)
        model.load_state_dict(state)
        return model

    counts = []
    fit = TrainLoop.fit

    def counting_fit(self, state, *args, **kwargs):
        state, history = fit(self, state, *args, **kwargs)
        counts.append(state.tx.count)
        return state, history

    monkeypatch_module.setattr(ttrain, "get_segmentation_network",
                               from_jax_init)
    monkeypatch_module.setattr(TrainLoop, "fit", counting_fit)
    dirs = {}
    for side, main, enc in (
            ("jax", jtrain.main, str(cohort / "jax_enc" / "cat_fold0")),
            ("torch", ttrain.main, str(cohort / "torch_enc" / "ssl_fold0"))):
        dirs[side] = cohort / f"finetune_{side}"
        main(_args(cohort, dirs[side], *_flags(cohort, enc)))
    return dict(dirs=dirs, encoder=encoder, counts=counts)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _weights(side, run):
    if side == "torch":
        return CheckpointManager(str(run), name="segmentation",
                                 fold=0).load_state_dict()
    ck = JaxCkpt(str(run), name="segmentation", fold=0)
    tree = ck.restore(ck.best_step())
    return from_flax(tree["params"],
                     (tree.get("variables") or {}).get("batch_stats"))


def test_finetune_metadata_matches_jax(runs):
    meta = {side: json.loads((d / "segmentation_fold0" / "metadata.json")
                             .read_text())
            for side, d in runs["dirs"].items()}
    for key in ("train_pids", "val_pids", "n_classes", "net_type"):
        assert meta["torch"][key] == meta["jax"][key], key
    for key in ("encoder_structure", "depth", "kernel_sizes", "strides",
                "res_type"):
        assert meta["torch"]["network_config"][key] == meta["jax"][
            "network_config"][key], key
    assert meta["torch"]["network_config"]["strides"] == [
        2, [2, 2, 1], [2, 2, 2]]
    assert meta["torch"]["transform_arguments"]["resize_size"] == [
        14, 14, 7] == meta["jax"]["transform_arguments"]["resize_size"]


def test_finetune_weights_match_jax(runs):
    """The weights kept, the frozen encoder leaves (bit-equal to the SSL
    checkpoint's), the moved ones, and one update an epoch."""
    got = _weights("torch", runs["dirs"]["torch"])
    want = _weights("jax", runs["dirs"]["jax"])
    assert set(got) == set(want)
    for k, v in want.items():
        err = float((got[k] - v).abs().max())
        assert err <= TOL * max(1.0, float(v.abs().max())), (k, err)
    frozen = moved = 0
    for k, v in runs["encoder"].items():
        if k.rsplit(".", 1)[-1] in ("mean", "var"):
            continue
        path = flax_path(f"encoder_backbone.{k}", v)
        if KEPT in path:
            moved += not torch.equal(got[f"encoder_backbone.{k}"], v)
        else:
            assert torch.equal(got[f"encoder_backbone.{k}"], v), k
            frozen += 1
    assert frozen > 10 and moved > 3
    # two micro-steps an epoch, two epochs: two updates
    assert runs["counts"] == [2]


def test_test_cli_on_resized_run_matches_jax(runs, capsys):
    out = {}
    for side, main in (("jax", jtest.main), ("torch", ttest.main)):
        d = runs["dirs"][side]
        main(["--dataset_json", str(d.parent / "ds.json"), "--dev", "cpu",
              "--checkpoint_dir", str(d), "--metric_path",
              str(d / "test.csv")])
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("{")]
        out[side] = json.loads(lines[-1])
    assert out["torch"]["n_cases"] == out["jax"]["n_cases"] == 5
    for k in ("dice", "iou"):
        assert abs(out["torch"][k] - out["jax"][k]) <= TOL, k


def _encoder_warm_start(model, ck_path):
    return tck.subtree_warm_start(model, ck_path, "encoder_backbone",
                                  tck.ENCODER_SOURCES)


def test_encoder_warm_start_errors(runs, cohort, caplog):
    model = UNet(**{k: v for k, v in resnet_encoder_config(
        SSL).items()}, norm_type="batch", upscale_type="transpose")
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        _encoder_warm_start(model, str(cohort / "reference.pt"))
    with caplog.at_level(logging.INFO):
        n = _encoder_warm_start(model, str(cohort / "torch_enc" / "ssl"))
    assert n == len([k for k in runs["encoder"]
                     if k.rsplit(".", 1)[-1] not in ("mean", "var")])
    other = UNet(**{**resnet_encoder_config(
        {"structure": [[6, 6, 3, 1], [10, 10, 3, 1]],
         "maxpool_structure": BACKBONE["maxpool_structure"]})},
        norm_type="batch")
    with pytest.raises(ValueError, match="matched no parameters"):
        _encoder_warm_start(other, str(cohort / "torch_enc" / "ssl"))
    # the JAX CLI looks for the subtree at the top of its checkpoint only
    with pytest.raises(ValueError, match="matched NO parameters"):
        jtrain.main(_args(cohort, cohort / "jax_quirk", *_flags(
            cohort, str(cohort / "jax_enc" / "ssl_fold0"))))


def test_mc_dropout_without_dropout_is_the_deterministic_path():
    """Dropout 0: the mean of 4 training-mode forwards is the eval
    forward, on both sides (instance norm: train and eval agree)."""
    x = np.random.default_rng(3).normal(size=SHAPE + (1,)).astype(
        np.float32)
    jm = JaxUNet(**FLAGSHIP_SMALL)
    params = random_flax_params(jm, jnp.zeros((1,) + SHAPE + (1,)), seed=4)

    def jbase(p, v, rng=None):
        # the whole-volume path hands one unbatched volume
        rngs = {"dropout": rng} if rng is not None else None
        return jm.apply({"params": p}, v[None], train=rng is not None,
                        rngs=rngs)[0][0]

    want = np.asarray(JaxInference(jbase, [params], mc_iterations=4)(
        jnp.asarray(x)))
    tm = UNet(**FLAGSHIP_SMALL)
    tm.load_state_dict(from_flax(params))

    def base(model, v, mc=False):
        model.train(mc)
        return model(v, heads=False)

    with torch.no_grad():
        got = SegmentationInference(base, [tm.eval()], mc_iterations=4)(
            torch.from_numpy(x)).numpy()
        plain = SegmentationInference(base, [tm.eval()])(
            torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, plain, atol=1e-5)


def test_mc_dropout_spread_shrinks_with_iterations():
    """Dropout 0.5: over 6 seeds, the variance of the 16-draw mean is
    about a sixteenth of one draw's; held between a 32nd and an 8th."""
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=SHAPE + (1,)).astype(np.float32))
    model = UNet(**{**FLAGSHIP_SMALL, "dropout_param": 0.5})

    def base(m, v, mc=False):
        m.train(mc)
        return m(v, heads=False)

    def draws(k):
        outs = []
        for seed in range(6):
            seed_dropout(model, torch.Generator().manual_seed(seed))
            with torch.no_grad():
                outs.append(SegmentationInference(
                    base, [model], mc_iterations=k)(x))
        return torch.stack(outs).var(0).mean()

    ratio = float(draws(16) / draws(1))
    assert 1 / 32 < ratio < 1 / 8, ratio


def test_predict_mc_iterations_runs(runs, capsys):
    run = runs["dirs"]["torch"]
    out = run / "mc"
    tpredict.main(["--dataset_json", str(run.parent / "ds.json"),
                   "--checkpoint_dir", str(run), "--dev", "cpu",
                   "--output_path", str(out), "--mc_iterations", "2",
                   "--prediction_ids", "case_0"])
    pred = tnifti.read_nifti(str(out / "case_0_prob.nii.gz")).data
    assert pred.shape == SHAPE and np.isfinite(pred).all()
    assert 0.0 <= pred.min() and pred.max() <= 1.0
