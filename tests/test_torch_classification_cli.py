"""
The port's classification entry points on the CPU.

``classification train --dev cpu`` trains the tiny CatNet (two stages,
batch ensembles of 2, batch norm) on a 6-case 16x16x8 synthetic cohort
and writes checkpoints whose metadata carries what the JAX trainer
records; ``classification test`` and ``predict`` serve them. The port's
``test`` and ``predict`` on a checkpoint agree with the JAX CLI's on a
JAX checkpoint of the same weights and running statistics within 1e-4
(f32 forwards of a few layers; the metrics are ranks and shares).
``--dev`` defaults to cuda and raises where there is no GPU; networks
that are not ported raise ``NotImplementedError``. Each experiment logger
flag gives the metric logger the JAX CLI's arguments, with which both
packages' loggers write the same CSV and warn alike.

The four net types ``vit``, ``factorized_vit``, ``ord`` (three grades)
and ``unet``: the port's ``test`` and ``predict`` (probabilities,
``--prediction_type pre_bias``, the ``features`` refusal) against the
JAX CLI's on the same seeded weights within ``TOL``, then the port's
``train``, ``test`` and ``predict`` on the cohort, one run with
``--mask_keys``, ``--image_masking`` and ``--image_crop_from_mask``;
the masking and cropping of the port's ``ClassificationTransforms``
against the JAX one's, and the port's CLIs on a masked checkpoint
against the JAX CLI's.

With ``--clinical_feature_keys`` (two numeric features of the cohort) the
JAX CLI and the port's train, from the same initial weights (the JAX
CLI's init, moved into the port's network), then test and predict on
what each wrote: the checkpoints' metadata, the test metrics and the
probabilities agree within ``TOL``. Both steps apply the parameters
alone, so the batch norms normalise by each batch in training and the
checkpoints keep the initial (0, 1) statistics that test and predict
normalise by.
"""

import json
import os

import jax
import jax.numpy as jnp
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
from adell_mri_torch.data import nifti as tnifti
from adell_mri_torch.entrypoints.classification import predict as tpredict
from adell_mri_torch.entrypoints.classification import test as ttest
from adell_mri_torch.entrypoints.classification import train as ttrain
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.train.checkpoints import CheckpointManager
from test_torch_logging import compare_loggers, logger_arguments
from test_torch_unet import random_flax_params

LPS = np.diag([-1.0, -1.0, 2.0, 1.0])
SHAPE = (16, 16, 8)
N_CASES = 6
TOL = 1e-4
NETWORK = {"resnet_structure": [[8, 16, 3, 1], [16, 32, 3, 1]],
           "maxpool_structure": [[2, 2, 2], [2, 2, 1]],
           "batch_ensemble": 2, "res_type": "resnet"}
GRADES = ["a", "b", "c", "a", "c", "b"]
AGES = [61.0, 55.5, 70.0, 48.0, 66.5, 59.0]
PSA = [4.2, 7.9, 12.5, 3.1, 9.6, 5.5]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """Six cases: a bright block in the positives (label 1), noise
    elsewhere; a string ``grade`` for the multiclass runs."""
    root = tmp_path_factory.mktemp("cls_cohort")
    rng = np.random.default_rng(0)
    ds = {}
    for i in range(N_CASES):
        label = i % 2
        img = rng.normal(size=SHAPE).astype(np.float32)
        if label:
            img[4:10, 5:12, 2:6] += 3.0
        path = str(root / f"case_{i}_T2.nii.gz")
        tnifti.write_nifti(path, img, LPS)
        ds[f"case_{i}"] = {"T2": path, "label": label, "grade": GRADES[i],
                           "age": AGES[i], "psa": PSA[i]}
    (root / "ds.json").write_text(json.dumps(ds))
    (root / "cat.yaml").write_text(yaml.safe_dump(
        {**NETWORK, "learning_rate": 0.01, "batch_size": 2}))
    return root


def _train_args(root, ckpt, *extra):
    return [
        "--dataset_json", str(root / "ds.json"), "--image_keys", "T2",
        "--config_file", str(root / "cat.yaml"),
        "--pad_size", *map(str, SHAPE), "--target_spacing", "1", "1", "2",
        "--max_epochs", "2", "--n_folds", "1", "--dev", "cpu",
        "--checkpoint_dir", str(ckpt), "--metric_path",
        str(ckpt / "metrics.csv"), *extra,
    ]


def _last_json(out: str):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith(("{", "["))][-1])


def test_train_test_predict_on_cpu(cohort, capsys, caplog):
    """Binary: crops, augmentation, mixup, label smoothing, class weights,
    the bias correction, SWA, early stopping; then a resume; then test
    and predict on what it wrote."""
    ckpt = cohort / "ckpt_bin"
    extra = ["--random_crop_size", "12", "12", "8",
             "--augment", "intensity", "noise", "affine", "flip",
             "--mixup_alpha", "0.4", "--partial_mixup", "0.5",
             "--label_smoothing", "0.1", "--class_weights", "2.0",
             "--correct_classification_bias", "--swa",
             "--early_stopping", "5", "--seed", "3"]
    cli_main(["classification", "train", *_train_args(cohort, ckpt, *extra)])
    fold = ckpt / "classification_fold0"
    assert sorted(os.listdir(fold)) == ["best.json", "last.pt",
                                        "metadata.json", "model.pt"]
    meta = json.loads((fold / "metadata.json").read_text())
    assert meta["net_type"] == "cat" and meta["n_classes"] == 2
    assert meta["network_config"]["batch_ensemble"] == 2
    assert meta["transform_arguments"]["target_size"] == list(SHAPE)
    assert meta["transform_arguments"]["label_key"] == "label"
    assert len(meta["train_pids"]) + len(meta["val_pids"]) == N_CASES
    state = torch.load(fold / "model.pt", weights_only=True)
    stats = [k for k in state if k.endswith(".mean")]
    assert stats and any(float(state[k].abs().max()) > 0 for k in stats)
    last = torch.load(fold / "last.pt", weights_only=True)
    assert last["epoch"] == 2 and set(last["variables"]) == {
        k for k in state if k.endswith((".mean", ".var"))}
    rows = (ckpt / "metrics.csv").read_text()
    assert "val_loss" in rows and "acc" in rows

    caplog.set_level("INFO")
    cli_main(["classification", "train", *_train_args(cohort, ckpt, *extra),
              "--resume_from_last", "--max_epochs", "3"])
    assert "fold 0: resuming from epoch 2" in caplog.text
    assert torch.load(fold / "last.pt", weights_only=True)["epoch"] == 3

    capsys.readouterr()
    cli_main(["classification", "test", "--dataset_json",
              str(cohort / "ds.json"), "--checkpoint_dir", str(ckpt),
              "--dev", "cpu", "--metric_path", str(ckpt / "test.csv")])
    result = _last_json(capsys.readouterr().out)
    assert result["n_cases"] == N_CASES
    assert 0.0 <= result["auc"] <= 1.0 and "f1" in result
    out = cohort / "pred_bin.json"
    cli_main(["classification", "predict", "--dataset_json",
              str(cohort / "ds.json"), "--checkpoint_dir", str(ckpt),
              "--dev", "cpu", "--output_path", str(out)])
    printed = _last_json(capsys.readouterr().out)
    preds = json.loads(out.read_text())
    assert preds == printed and sorted(preds) == sorted(
        f"case_{i}" for i in range(N_CASES))
    assert all(0.0 <= v <= 1.0 for v in preds.values())


def test_multiclass_train_and_serve_on_cpu(cohort, capsys):
    """Multiclass string labels (``--possible_labels``) under bf16 with
    stratified folds, weighted sampling, class weights and adamw; test
    takes the multiclass metrics, predict the softmax, the logits and the
    pooled features, and two ID groups give the list of records."""
    ckpt = cohort / "ckpt_multi"
    cli_main(["classification", "train", *_train_args(
        cohort, ckpt, "--label_keys", "grade", "--possible_labels", "a",
        "b", "c", "--n_folds", "2", "--weighted_sampling",
        "--class_weights", "1.0", "2.0", "1.0", "--optimizer", "adamw",
        "--precision", "bf16", "--batch_size", "2", "--max_epochs", "1")])
    for k in range(2):
        meta = json.loads((ckpt / f"classification_fold{k}" /
                           "metadata.json").read_text())
        assert meta["n_classes"] == 3
        assert meta["transform_arguments"]["possible_labels"] == [
            "a", "b", "c"]
    capsys.readouterr()
    cli_main(["classification", "test", "--dataset_json",
              str(cohort / "ds.json"), "--checkpoint_dir", str(ckpt),
              "--dev", "cpu", "--precision", "bf16", "--metric_path",
              str(ckpt / "test.csv")])
    result = _last_json(capsys.readouterr().out)
    assert result["n_cases"] == N_CASES and "precision_c2" in result
    for kind, check in (
            ("probability", lambda v: len(v) == 3
             and abs(sum(v) - 1.0) < 1e-5),
            ("logit", lambda v: len(v) == 3),
            ("features", lambda v: len(v) == 16)):
        out = cohort / f"pred_{kind}.json"
        cli_main(["classification", "predict", "--dataset_json",
                  str(cohort / "ds.json"), "--checkpoint_dir", str(ckpt),
                  "--dev", "cpu", "--prediction_type", kind,
                  "--output_path", str(out)])
        preds = json.loads(out.read_text())
        assert len(preds) == N_CASES and all(map(check, preds.values()))
    out = cohort / "pred_groups.json"
    cli_main(["classification", "predict", "--dataset_json",
              str(cohort / "ds.json"), "--checkpoint_dir", str(ckpt),
              "--dev", "cpu", "--prediction_ids", "case_0,case_1",
              "case_2", "--output_path", str(out)])
    records = json.loads(out.read_text())
    assert [r["prediction_ids"] for r in records] == [
        ["case_0", "case_1"], ["case_2"]]
    assert records[0]["checkpoint"].endswith("classification_fold0")


def _checkpoints(root, n_classes):
    """The same seeded weights and running statistics as a JAX checkpoint
    and a port one."""
    metadata = {
        "network_config": NETWORK,
        "transform_arguments": {
            "image_keys": ["T2"],
            "label_key": "label" if n_classes == 2 else "grade",
            "target_spacing": [1.0, 1.0, 2.0],
            "target_size": list(SHAPE), "adc_keys": [],
            "possible_labels": None if n_classes == 2 else ["a", "b", "c"],
        },
        "n_classes": n_classes,
        "net_type": "cat",
    }
    jm = jget_network("cat", NETWORK, n_classes=n_classes)
    x = jnp.asarray(np.random.default_rng(1).uniform(
        size=(4,) + SHAPE + (1,)).astype(np.float32))
    params = jax.tree.map(jnp.asarray, random_flax_params(
        jm, x, seed=30 + n_classes))
    bs = jm.init(jax.random.PRNGKey(0), x)["batch_stats"]
    for i in range(4):
        _, upd = jm.apply({"params": params, "batch_stats": bs}, x,
                          train=True, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(i),
                                "ensemble": jax.random.PRNGKey(i)})
        bs = upd["batch_stats"]
    jdir = root / f"jax_ckpt_{n_classes}"
    jck = JaxCkpt(str(jdir), name="classification", fold=0,
                  metadata=metadata)
    jck.save(1, {"params": params, "batch_stats": bs},
             metrics={"val_loss": 0.5})
    jck.wait()
    tdir = root / f"torch_ckpt_{n_classes}"
    CheckpointManager(str(tdir), name="classification", fold=0,
                      metadata=metadata).save(from_flax(params, bs), step=1,
                                              value=0.5)
    return jdir, tdir


@pytest.mark.parametrize("n_classes", [2, 3])
def test_test_and_predict_match_jax(cohort, capsys, n_classes):
    jdir, tdir = _checkpoints(cohort, n_classes)
    common = ["--dataset_json", str(cohort / "ds.json"), "--dev", "cpu"]
    jax_main(["classification", "test", *common, "--checkpoint_dir",
              str(jdir), "--metric_path", str(cohort / "m_jax.csv")])
    want = _last_json(capsys.readouterr().out)
    cli_main(["classification", "test", *common, "--checkpoint_dir",
              str(tdir), "--metric_path", str(cohort / "m_torch.csv")])
    got = _last_json(capsys.readouterr().out)
    assert set(got) == set(want) and got["n_cases"] == N_CASES
    assert got.pop("checkpoint").endswith("classification_fold0")
    want.pop("checkpoint")
    for k, v in want.items():
        if isinstance(v, float) and np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - v) <= TOL, (k, got[k], v)
    jout, tout = cohort / "jpred.json", cohort / "tpred.json"
    jax_main(["classification", "predict", *common, "--checkpoint_dir",
              str(jdir), "--output_path", str(jout)])
    cli_main(["classification", "predict", *common, "--checkpoint_dir",
              str(tdir), "--output_path", str(tout)])
    want, got = json.loads(jout.read_text()), json.loads(tout.read_text())
    assert set(got) == set(want)
    for pid, v in want.items():
        np.testing.assert_allclose(got[pid], v, atol=TOL, rtol=0)


@pytest.mark.parametrize("flags", [
    ["--logger_type", "wandb"], ["--logger_type", "mlflow"],
    ["--project_name", "p"], ["--summary_name", "s"],
    ["--summary_dir", "d"], ["--tracking_uri", "file:x"], ["--log_model"],
    ["--logger_type", "wandb", "--log_model"]])
def test_train_logger_flags(cohort, flags, monkeypatch, tmp_path):
    """Each experiment logger flag: both CLIs build their metric logger
    with the same arguments, and with those both packages' loggers write
    the same CSV and warn alike (neither tracker is installed)."""

    def run(tag, flags):
        # both stop before anything is written
        args = _train_args(cohort, tmp_path / "ckpt", *flags)
        if tag == "jax":
            jax_main(["classification", "train", *args])
        else:
            ttrain.main(args)

    seen = logger_arguments(monkeypatch, jtrain, flags, run)
    assert seen["port"] == seen["jax"]
    _, warned = compare_loggers(seen["port"], tmp_path, artifact=cohort)
    assert len(warned) == ("--logger_type" in flags)


# what the port still refuses: networks it has not ported (a 2D or
# conditioned U-Net encoder, activations of the JAX registry it lacks,
# ViT's mixture of experts), each a config written beside the cohort's
_2D = {"spatial_dimensions": 2}
_ELU = {**NETWORK, "act_fn": "elu"}
_MOE = {"patch_size": [4, 4, 2], "embedding_size": 32, "n_heads": 2,
        "number_of_blocks": 1, "moe_experts": 2}


@pytest.mark.parametrize(
    "flags, network",
    [([], _ELU),
     (["--classification_net_type", "unet"], _2D),
     (["--classification_net_type", "unet"], {"feature_conditioning": 2}),
     (["--classification_net_type", "convnext"], _ELU),
     (["--classification_net_type", "vit"], _MOE)],
)
def test_train_unported_flags_raise(cohort, flags, network):
    if network is not None:
        path = cohort / f"unported_{abs(hash(str(network)))}.yaml"
        path.write_text(yaml.safe_dump(network))
        flags = flags + ["--config_file", str(path)]
    with pytest.raises(NotImplementedError):
        ttrain.main(_train_args(cohort, cohort / "ckpt_x", *flags))


@pytest.mark.parametrize(
    "entry, net_type, network",
    [(ttest, "unet", _2D), (tpredict, "unet", _2D), (ttest, "cat", _ELU),
     (tpredict, "cat", _ELU), (tpredict, "vit", _MOE)],
)
def test_serving_unported_flags_raise(cohort, entry, net_type, network):
    """A checkpoint of a network the port has not ported (its metadata is
    enough: the network is built before its weights are read)."""
    root = cohort / f"unported_{net_type}_{entry.__name__.split('.')[-1]}"
    CheckpointManager(str(root), name="classification", fold=0, metadata={
        "network_config": network, "n_classes": 2, "net_type": net_type,
        "transform_arguments": {"image_keys": ["T2"],
                                "target_spacing": [1.0, 1.0, 2.0],
                                "target_size": list(SHAPE)}})
    args = ["--dataset_json", str(cohort / "ds.json"), "--dev", "cpu",
            "--checkpoint_dir", str(root)]
    if entry is tpredict:
        args += ["--output_path", str(cohort / "unused.json")]
    with pytest.raises(NotImplementedError):
        entry.main(args)


def test_dev_defaults_to_cuda(cohort, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _train_args(cohort, cohort / "ckpt_cuda")
    i = args.index("--dev")
    with pytest.raises(RuntimeError, match="--dev cpu"):
        ttrain.main(args[:i] + args[i + 2:])


# net id -> (--classification_net_type, network config); the CatNet has no
# batch ensembles: the JAX CLI's step with features hands its model a
# dropout stream only, and a batch-ensemble CatNet stops there at its
# first step (flax's InvalidRngError, no "ensemble" stream)
HYBRID_NETS = {
    "cat_convnext": ("convnext", {
        "resnet_structure": [[8, 16, [5, 5, 3], 1], [16, 32, 3, 1]],
        "maxpool_structure": [[2, 2, 2], [2, 2, 1]]}),
    "vgg": ("vgg", {"first_depth": 4, "n_blocks": 2}),
}


@pytest.mark.parametrize("net", list(HYBRID_NETS))
def test_clinical_features_match_jax_cli(cohort, capsys, monkeypatch, net):
    """``--clinical_feature_keys age psa``: the JAX and the port's
    ``classification train`` (f32, two epochs, no augmentation) from the
    JAX CLI's initial weights, then each side's ``test`` and ``predict``
    on its own checkpoint: metadata, metrics and probabilities within
    ``TOL``; the saved statistics are the initial (0, 1) on both sides;
    ``--prediction_type features`` raises on both sides."""
    net_type, network = HYBRID_NETS[net]
    (cohort / f"{net}.yaml").write_text(yaml.safe_dump(
        {**network, "learning_rate": 0.01, "batch_size": 2}))
    mat = np.asarray([AGES, PSA]).T
    means, stds = mat.mean(0).tolist(), mat.std(0).tolist()
    jm = jget_network(net_type, network, clinical_feature_means=means,
                      clinical_feature_stds=stds)
    init = jm.init({"params": jax.random.PRNGKey(0)},
                   np.zeros((1,) + SHAPE + (1,), np.float32),
                   np.zeros((1, 2), np.float32))
    build = ttrain.get_classification_network

    def from_jax_init(*args, **kwargs):
        model = build(*args, **kwargs)
        model.load_state_dict(from_flax(init["params"],
                                        init.get("batch_stats")))
        return model

    monkeypatch.setattr(ttrain, "get_classification_network", from_jax_init)
    root = {}
    for side, main in (("jax", jtrain.main), ("torch", ttrain.main)):
        root[side] = cohort / f"hybrid_{net}_{side}"
        main(_train_args(cohort, root[side]) + [
            "--config_file", str(cohort / f"{net}.yaml"),
            "--classification_net_type", net_type,
            "--clinical_feature_keys", "age", "psa", "--seed", "0"])
    metas = {side: json.loads((d / "classification_fold0" / "metadata.json")
                              .read_text()) for side, d in root.items()}
    for key in ("net_type", "n_classes", "train_pids", "val_pids"):
        assert metas["torch"][key] == metas["jax"][key], key
    for key in ("clinical_feature_means", "clinical_feature_stds"):
        np.testing.assert_allclose(metas["torch"][key], metas["jax"][key],
                                   rtol=1e-12)
    assert metas["torch"]["transform_arguments"][
        "clinical_feature_keys"] == ["age", "psa"]
    state = torch.load(root["torch"] / "classification_fold0" / "model.pt",
                       weights_only=True)
    stats = [k for k in state if k.endswith((".mean", ".var"))]
    assert stats and all(torch.equal(state[k], torch.full_like(
        state[k], float(k.endswith(".var")))) for k in stats)
    common = ["--dataset_json", str(cohort / "ds.json"), "--dev", "cpu"]
    out = {}
    for side, main in (("jax", jax_main), ("torch", cli_main)):
        capsys.readouterr()
        main(["classification", "test", *common, "--checkpoint_dir",
              str(root[side]), "--metric_path", str(root[side] / "t.csv")])
        test = _last_json(capsys.readouterr().out)
        test.pop("checkpoint")
        pred = root[side] / "pred.json"
        main(["classification", "predict", *common, "--checkpoint_dir",
              str(root[side]), "--output_path", str(pred)])
        out[side] = (test, json.loads(pred.read_text()))
        with pytest.raises(ValueError, match="features"):
            main(["classification", "predict", *common, "--checkpoint_dir",
                  str(root[side]), "--prediction_type", "features",
                  "--output_path", str(pred)])
    (want, want_p), (got, got_p) = out["jax"], out["torch"]
    assert set(got) == set(want) and got["n_cases"] == N_CASES
    for k, v in want.items():
        if isinstance(v, float) and np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - v) <= TOL, (k, got[k], v)
    assert set(got_p) == set(want_p)
    for pid, v in want_p.items():
        np.testing.assert_allclose(got_p[pid], v, atol=TOL, rtol=0)


# net type -> (network config, number of classes); tiny widths
NEW_NETS = {
    "vit": ({"patch_size": [4, 4, 2], "embedding_size": 32,
             "number_of_blocks": 2, "n_heads": 2, "mlp_structure": [24],
             "dropout_rate": 0.1}, 2),
    "factorized_vit": ({"patch_size": [4, 4], "embed_dim": 32,
                        "n_blocks": 2, "n_heads": 2}, 2),
    "ord": ({"resnet_structure": [[8, 16, 3, 1], [16, 32, 3, 1]]}, 3),
    "unet": ({"depth": [8, 16, 32], "conv_type": "resnet",
              "link_type": "residual", "norm_type": "instance",
              "dropout_param": 0.1}, 2),
}


@pytest.fixture(scope="module")
def masked(cohort):
    """A mask for each case (a box and one stray voxel, so the hull is no
    box) and a dataset JSON that names them."""
    ds = json.loads((cohort / "ds.json").read_text())
    for i, pid in enumerate(sorted(ds)):
        mask = np.zeros(SHAPE, np.float32)
        mask[3 + i % 2:12, 4:11, 2:6] = 1.0
        mask[5, 1 + i % 3, 3] = 1.0
        path = str(cohort / f"{pid}_mask.nii.gz")
        tnifti.write_nifti(path, mask, LPS)
        ds[pid]["mask"] = path
    (cohort / "ds_mask.json").write_text(json.dumps(ds))
    return cohort / "ds_mask.json"


def _net_checkpoints(root, tag, net_type, network, n_classes, seed,
                     **t_args):
    """A JAX checkpoint and a port one of the same seeded weights (and
    running statistics drawn from the seed, where there are batch
    norms), with the metadata ``classification train`` writes."""
    metadata = {
        "network_config": network,
        "transform_arguments": {
            "image_keys": ["T2"],
            "label_key": "label" if n_classes == 2 else "grade",
            "target_spacing": [1.0, 1.0, 2.0],
            "target_size": list(SHAPE), "adc_keys": [],
            "possible_labels": None if n_classes == 2 else ["a", "b", "c"],
            **t_args,
        },
        "n_classes": n_classes,
        "net_type": net_type,
    }
    jm = jget_network(net_type, network, n_classes=n_classes)
    x = jnp.zeros((1,) + SHAPE + (1,))
    params = jax.tree.map(jnp.asarray, random_flax_params(jm, x, seed=seed))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed + 1)
    bs = jax.tree.map(lambda t: jnp.asarray(rng.uniform(
        0.5, 1.5, t.shape).astype(np.float32)),
        shapes.get("batch_stats", {}))
    jdir, tdir = root / f"jax_{tag}", root / f"torch_{tag}"
    jck = JaxCkpt(str(jdir), name="classification", fold=0,
                  metadata=metadata)
    jck.save(1, {"params": params, **({"batch_stats": bs} if bs else {})},
             metrics={"val_loss": 0.5})
    jck.wait()
    CheckpointManager(str(tdir), name="classification", fold=0,
                      metadata=metadata).save(from_flax(params, bs), step=1,
                                              value=0.5)
    return jdir, tdir


def _both_serve(capsys, ds_json, jdir, tdir, out_dir, *extra):
    """``test`` and ``predict`` (with ``extra``) of the JAX CLI on
    ``jdir`` and the port's on ``tdir``: their metrics and predictions
    within ``TOL``."""
    common = ["--dataset_json", str(ds_json), "--dev", "cpu"]
    results = {}
    for side, main, d in (("jax", jax_main, jdir), ("torch", cli_main,
                                                   tdir)):
        capsys.readouterr()
        main(["classification", "test", *common, "--checkpoint_dir", str(d),
              "--metric_path", str(out_dir / f"m_{side}.csv")])
        test = _last_json(capsys.readouterr().out)
        test.pop("checkpoint")
        pred = out_dir / f"p_{side}.json"
        main(["classification", "predict", *common, "--checkpoint_dir",
              str(d), "--output_path", str(pred), *extra])
        results[side] = (test, json.loads(pred.read_text()))
    (want, want_p), (got, got_p) = results["jax"], results["torch"]
    assert set(got) == set(want) and got["n_cases"] == N_CASES
    for k, v in want.items():
        if isinstance(v, float) and np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - v) <= TOL, (k, got[k], v)
    assert set(got_p) == set(want_p)
    for pid, v in want_p.items():
        np.testing.assert_allclose(got_p[pid], v, atol=TOL, rtol=0)
    return got_p


@pytest.mark.parametrize("net_type", list(NEW_NETS))
def test_new_net_types_match_jax_cli(cohort, capsys, net_type):
    """``test`` and ``predict`` of each new net type against the JAX
    CLI's on the same weights: ``ord`` on three grades (its class
    probabilities from the cumulative logits; ``--prediction_type
    pre_bias`` the score on both sides), the others binary
    (``pre_bias`` falls back to probabilities on both sides); both sides
    refuse ``--prediction_type features`` for these net types."""
    network, n_classes = NEW_NETS[net_type]
    jdir, tdir = _net_checkpoints(cohort, net_type, net_type, network,
                                  n_classes, seed=80)
    out = cohort / f"serve_{net_type}"
    out.mkdir()
    probs = _both_serve(capsys, cohort / "ds.json", jdir, tdir, out)
    if n_classes == 3:
        assert all(len(v) == 3 and abs(sum(v) - 1) < 1e-5
                   for v in probs.values())
    pre_bias = _both_serve(capsys, cohort / "ds.json", jdir, tdir, out,
                           "--prediction_type", "pre_bias")
    if net_type == "ord":
        assert all(len(v) == 1 for v in pre_bias.values())
    else:
        assert pre_bias == pytest.approx(probs, abs=1e-6)
    for main, d in ((jax_main, jdir), (cli_main, tdir)):
        with pytest.raises(ValueError, match="return_features"):
            main(["classification", "predict", "--dataset_json",
                  str(cohort / "ds.json"), "--dev", "cpu",
                  "--checkpoint_dir", str(d), "--prediction_type",
                  "features", "--output_path", str(out / "f.json")])


@pytest.mark.parametrize("masking, cropping", [(True, False), (False, True),
                                               (True, True)])
def test_mask_transforms_match_jax(masked, masking, cropping):
    """``ClassificationTransforms`` with a mask key: the images multiplied
    by the mask's slice-wise convex hull, cropped to its bounding box with
    a 16-voxel margin and back to the target size, or both; the port's
    load equals the JAX one's (f32, 1e-6), the mask gone from the
    sample."""
    from adell_mri_tpu.transforms import (
        ClassificationTransforms as JaxTransforms,
    )
    from adell_mri_torch.transforms.pipeline import ClassificationTransforms

    ds = json.loads(masked.read_text())
    kwargs = dict(image_keys=["T2"], label_key="label",
                  target_spacing=[1.0, 1.0, 2.0], target_size=[12, 12, 6],
                  mask_key="mask", image_masking=masking,
                  image_crop_from_mask=cropping)
    jload = JaxTransforms(**kwargs).load_fn()
    tload = ClassificationTransforms(**kwargs).load_fn()
    for pid in sorted(ds)[:3]:
        entry = {**ds[pid], "identifier": pid}
        want, got = jload(dict(entry)), tload(dict(entry))
        assert got["image"].shape == (12, 12, 6, 1)
        np.testing.assert_allclose(got["image"], want["image"], atol=1e-6,
                                   rtol=0)
        assert got["label"] == want["label"]
        assert not {"fg_indices", "n_fg"} & set(got)


def test_masked_checkpoint_matches_jax_cli(masked, capsys):
    """A CatNet checkpoint trained with ``--mask_keys mask
    --image_masking --image_crop_from_mask``: the port's ``test`` and
    ``predict`` against the JAX CLI's on the same weights."""
    mask_args = dict(mask_key="mask", image_masking=True,
                     image_crop_from_mask=True)
    jdir, tdir = _net_checkpoints(masked.parent, "masked", "cat", NETWORK,
                                  2, seed=90, **mask_args)
    out = masked.parent / "serve_masked"
    out.mkdir()
    _both_serve(capsys, masked, jdir, tdir, out)


@pytest.mark.parametrize("net_type", list(NEW_NETS))
def test_new_net_types_train_and_serve_on_cpu(cohort, masked, capsys,
                                              net_type):
    """``classification train`` (one epoch), ``test`` and ``predict``
    for each new net type on the CPU; ``unet`` with ``--mask_keys``,
    ``--image_masking`` and ``--image_crop_from_mask``, which
    ``metadata.json`` keeps and serving repeats; ``ord`` on three grades
    with ``--prediction_type pre_bias``."""
    network, n_classes = NEW_NETS[net_type]
    ckpt = cohort / f"ckpt_{net_type}"
    (cohort / f"{net_type}.yaml").write_text(yaml.safe_dump(
        {**network, "learning_rate": 0.01, "batch_size": 2}))
    extra = ["--config_file", str(cohort / f"{net_type}.yaml"),
             "--classification_net_type", net_type, "--max_epochs", "1"]
    ds_json = cohort / "ds.json"
    if n_classes == 3:
        extra += ["--label_keys", "grade", "--possible_labels", "a", "b",
                  "c"]
    if net_type == "unet":
        ds_json = masked
        extra += ["--mask_keys", "mask", "--image_masking",
                  "--image_crop_from_mask"]
    args = _train_args(cohort, ckpt, *extra)
    args[args.index("--dataset_json") + 1] = str(ds_json)
    cli_main(["classification", "train", *args])
    meta = json.loads((ckpt / "classification_fold0" / "metadata.json")
                      .read_text())
    assert meta["net_type"] == net_type and meta["n_classes"] == n_classes
    t_args = meta["transform_arguments"]
    assert (t_args["mask_key"], t_args["image_masking"],
            t_args["image_crop_from_mask"]) == (
        ("mask", True, True) if net_type == "unet" else (None, False,
                                                        False))
    common = ["--dataset_json", str(ds_json), "--dev", "cpu",
              "--checkpoint_dir", str(ckpt)]
    capsys.readouterr()
    cli_main(["classification", "test", *common, "--metric_path",
              str(ckpt / "test.csv")])
    result = _last_json(capsys.readouterr().out)
    assert result["n_cases"] == N_CASES
    assert ("precision_c2" in result) == (n_classes == 3)
    out = ckpt / "pred.json"
    cli_main(["classification", "predict", *common, "--output_path",
              str(out), "--prediction_type", "pre_bias"])
    preds = json.loads(out.read_text())
    assert len(preds) == N_CASES
    if net_type == "ord":
        assert all(len(v) == 1 and np.isfinite(v[0])
                   for v in preds.values())
    else:
        assert all(0.0 <= v <= 1.0 for v in preds.values())
