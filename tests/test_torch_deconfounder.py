"""
``DeconfoundedNet``, ``correlation_penalty`` and the
``classification_deconfounder`` CLIs against the JAX package's, on the
CPU.

The modules on seeded numpy inputs and parameters moved through
``from_flax``: the four outputs with 0, 1 and 2 categorical confounders,
with and without continuous ones (f32, 1e-5 of each output's scale); one
step's loss and gradient against the JAX CLI's ``make_lm`` loss, written
out here as ``train.py`` writes it (loss 1e-5, each gradient 1e-4 of its
scale, the scale floored at 1e-2 of the largest gradient's: the biases
of the convs before instance norms have a true gradient of 0, which f32
leaves at rounding noise, about 2e-7 of the largest, in both packages).
The CLIs on one six-case 16x16x8 cohort with two categorical
confounders (3 and 2 values) and one continuous one: the JAX CLI trains
once and the port once; their metadata agree; the JAX checkpoint's
weights, moved into a port checkpoint, give the same ``test`` metrics
(1e-4) and ``predict`` JSON (1e-4: probabilities, surrogate classes,
continuous surrogates; with ``--ensemble mean`` over two checkpoints
too) as the JAX CLIs on the JAX checkpoint. Neither train CLI takes the
experiment loggers' flags.
"""

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from adell_mri_tpu.__main__ import main as jax_main
from adell_mri_tpu.entrypoints.classification_deconfounder import (
    test as jtest,
)
from adell_mri_tpu.entrypoints.classification_deconfounder.train import (
    build_deconfounder_model as jbuild,
)
from adell_mri_tpu.models.classification import losses as jlosses
from adell_mri_tpu.models.classification.deconfounded import (
    correlation_penalty as jpenalty,
)
from adell_mri_torch.__main__ import main as cli_main
from adell_mri_torch.data import nifti as tnifti
from adell_mri_torch.entrypoints.classification_deconfounder.train import (
    build_deconfounder_model,
    make_deconfounder_step,
)
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.classification.deconfounded import (
    correlation_penalty,
)
from adell_mri_torch.train.checkpoints import CheckpointManager
from test_torch_classification import _close

SHAPE = (16, 16, 8)
NET = {"resnet_structure": [[8, 16, 3, 1], [16, 32, 3, 1]],
       "norm_type": "instance"}
N_CASES = 6
TOL = 1e-4


def _params(jm, x, seed):
    shapes = jax.eval_shape(lambda v: jm.init(jax.random.PRNGKey(0), v), x)
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 0.3 if len(s.shape) == 1 else 1.0 / np.sqrt(
            np.prod(s.shape[:-1]))
        return jnp.asarray((rng.normal(size=s.shape) * scale).astype(
            np.float32))

    return jax.tree.map(draw, shapes["params"])


def _pair(cat_cards, n_cont, n_classes=2, n_features=8, seed=0):
    x = np.random.default_rng(seed).normal(
        size=(4,) + SHAPE + (1,)).astype(np.float32)
    jm = jbuild(NET, cat_cards, n_cont, n_classes, n_features=n_features)
    params = _params(jm, x, seed + 1)
    tm = build_deconfounder_model(NET, cat_cards, n_cont, n_classes,
                                  n_features=n_features)
    tm.load_state_dict(from_flax(params))
    return jm, params, tm.eval(), x


def test_correlation_penalty():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(6, 5)).astype(np.float32)
    b = rng.normal(size=(6, 3)).astype(np.float32)
    b[:, 1] = 2.0  # a constant column: its norm is floored at 1e-6
    _close(correlation_penalty(torch.from_numpy(a), torch.from_numpy(b)),
           jpenalty(a, b), 1e-5)


@pytest.mark.parametrize("cat_cards", [(), (3,), (3, 2)])
@pytest.mark.parametrize("n_cont", [0, 2])
def test_deconfounded_net_outputs(cat_cards, n_cont):
    jm, params, tm, x = _pair(list(cat_cards), n_cont)
    want = jm.apply({"params": params}, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got[0], want[0], 1e-5)
    assert len(got[1]) == len(want[1]) == len(cat_cards)
    for g, w in zip(got[1], want[1]):
        _close(g, w, 1e-5)
    if n_cont:
        _close(got[2], want[2], 1e-5)
    else:
        assert got[2] is None and want[2] is None
    _close(got[3], want[3], 1e-5)


def _jax_loss(jm, n_classes, cat_cards, weight):
    """The JAX CLI's ``make_lm`` loss (``train.py``)."""

    def lm(params, batch):
        logits, cat_preds, cont_pred, penalty = jm.apply(
            {"params": params}, batch["image"], train=True)
        if n_classes > 2:
            loss = jlosses.cross_entropy_loss(logits, batch["label"])
        else:
            loss = jlosses.binary_logistic_loss(logits, batch["label"])
        for i in range(len(cat_cards)):
            oh = jax.nn.one_hot(batch[f"cat_conf_{i}"], cat_cards[i])
            loss = loss + jnp.mean(
                optax.softmax_cross_entropy(cat_preds[i], oh))
        if cont_pred is not None:
            loss = loss + jnp.mean((cont_pred - batch["cont_conf"]) ** 2)
        return loss + weight * penalty

    return lm


@pytest.mark.parametrize("n_classes", [2, 3])
def test_deconfounder_step(n_classes):
    cat_cards, weight = [3, 2], 0.7
    jm, params, tm, x = _pair(cat_cards, 1, n_classes, seed=5)
    rng = np.random.default_rng(6)
    batch = {"image": x,
             "label": rng.integers(0, n_classes, 4).astype(
                 np.float32 if n_classes == 2 else np.int32),
             "cat_conf_0": rng.integers(0, 3, 4).astype(np.int32),
             "cat_conf_1": rng.integers(0, 2, 4).astype(np.int32),
             "cont_conf": rng.normal(size=(4, 1)).astype(np.float32)}
    want_loss, want_grads = jax.value_and_grad(
        _jax_loss(jm, n_classes, cat_cards, weight))(params, batch)
    step = make_deconfounder_step(tm, n_classes, weight, train=True)
    weights = {k: v.clone().requires_grad_(True)
               for k, v in tm.state_dict().items()}
    loss, metrics = step(weights, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(weights.values()))
    _close(loss, want_loss, 1e-5)
    assert set(metrics) == {"loss", "decorrelation"}
    want = from_flax(want_grads)
    floor = 1e-2 * max(float(w.abs().max()) for w in want.values())
    for name, g in zip(weights, grads):
        scale = max(float(want[name].abs().max()), floor)
        err = float((g - want[name]).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)


# -- the CLIs -----------------------------------------------------------------

LPS = np.diag([-1.0, -1.0, 2.0, 1.0])
SCANNERS = ["ge", "siemens", "ge", "philips", "siemens", "ge"]
SITES = ["a", "b", "a", "b", "a", "b"]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("deconf_cohort")
    rng = np.random.default_rng(0)
    ds = {}
    for i in range(N_CASES):
        img = rng.normal(size=SHAPE).astype(np.float32)
        if i % 2:
            img[4:10, 5:12, 2:6] += 3.0
        path = str(root / f"case_{i}_T2.nii.gz")
        tnifti.write_nifti(path, img, LPS)
        ds[f"case_{i}"] = {"T2": path, "label": i % 2,
                           "scanner": SCANNERS[i], "site": SITES[i],
                           "age": 50.0 + 3 * i}
    (root / "ds.json").write_text(json.dumps(ds))
    (root / "deconf.yaml").write_text(yaml.safe_dump(
        {**NET, "batch_size": 2, "learning_rate": 0.001}))
    return root


def _train_args(root, ckpt):
    return ["--dataset_json", str(root / "ds.json"), "--image_keys", "T2",
            "--cat_confounder_keys", "scanner", "site",
            "--cont_confounder_keys", "age",
            "--n_features_deconfounder", "8",
            "--config_file", str(root / "deconf.yaml"),
            "--pad_size", *map(str, SHAPE),
            "--target_spacing", "1", "1", "2", "--max_epochs", "1",
            "--n_folds", "1", "--dev", "cpu", "--seed", "1",
            "--checkpoint_dir", str(ckpt), "--cache_rate", "0"]


@pytest.fixture(scope="module")
def runs(cohort):
    """The JAX CLI's checkpoint, the same weights as a port checkpoint,
    and the port CLI's own run."""
    jdir, tdir, own = (cohort / "jax_ckpt", cohort / "port_ckpt",
                       cohort / "own_ckpt")
    jax_main(["classification_deconfounder", "train",
              *_train_args(cohort, jdir)])
    cli_main(["classification_deconfounder", "train",
              *_train_args(cohort, own)])
    args = argparse.Namespace(checkpoint_dir=str(jdir), checkpoint_name=None,
                              n_classes=2, image_keys=None)
    _, params, _, _, _ = jtest._rebuild(args)
    meta = json.loads((jdir / "deconfounder_fold0" / "metadata.json")
                      .read_text())
    CheckpointManager(str(tdir), name="deconfounder", fold=0,
                      metadata=meta).save(from_flax(params))
    return jdir, tdir, own


def test_train_metadata(runs):
    jdir, _, own = runs
    want = json.loads((jdir / "deconfounder_fold0" / "metadata.json")
                      .read_text())
    got = json.loads((own / "deconfounder_fold0" / "metadata.json")
                     .read_text())
    assert got["cat_confounder_cards"] == want["cat_confounder_cards"] \
        == [3, 2]
    for key in ("network_config", "cat_confounder_keys",
                "cont_confounder_keys", "n_classes",
                "n_features_deconfounder", "transform_arguments"):
        assert got[key] == want[key], key
    assert (own / "deconfounder_fold0" / "model.pt").exists()


def test_test_metrics(runs, cohort, capsys):
    jdir, tdir, _ = runs
    common = ["--dataset_json", str(cohort / "ds.json"), "--dev", "cpu"]
    out = {}
    for tag, main, ckpt in (("jax", jax_main, jdir), ("port", cli_main,
                                                      tdir)):
        capsys.readouterr()
        main(["classification_deconfounder", "test", *common,
              "--checkpoint_dir", str(ckpt),
              "--metric_path", str(cohort / f"{tag}_test.csv")])
        out[tag] = json.loads(capsys.readouterr().out.strip()
                              .splitlines()[-1])
    want, got = out["jax"], out["port"]
    assert set(got) == set(want) and got["n_cases"] == N_CASES
    for k, v in want.items():
        if isinstance(v, float) and np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - v) <= TOL, (k, got[k], v)
    assert (cohort / "port_test.csv").read_text().splitlines()[0] == \
        (cohort / "jax_test.csv").read_text().splitlines()[0]


def _predictions_close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _predictions_close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _predictions_close(g, w)
    elif isinstance(want, str) or want is None:
        assert got == want
    else:
        assert abs(got - want) <= TOL, (got, want)


@pytest.mark.parametrize("flags", [
    [], ["--ensemble", "mean", "--checkpoint", "{run}", "{run}"]])
def test_predict(runs, cohort, flags):
    jdir, tdir, _ = runs
    out = {}
    for tag, main, ckpt in (("jax", jax_main, jdir), ("port", cli_main,
                                                      tdir)):
        path = cohort / f"{tag}_pred_{len(flags)}.json"
        run = str(ckpt / "deconfounder_fold0")
        main(["classification_deconfounder", "predict",
              "--dataset_json", str(cohort / "ds.json"), "--dev", "cpu",
              "--checkpoint_dir", str(ckpt), "--output_path", str(path),
              *[f.format(run=run) for f in flags]])
        out[tag] = json.loads(path.read_text())
    want, got = out["jax"], out["port"]
    if flags:
        # the records name the checkpoints by their paths, which differ
        for record in want + got:
            if record["checkpoint"] != "ensemble":
                record["checkpoint"] = "run"
        assert got[-1]["checkpoint"] == "ensemble"
    else:
        assert len(got) == N_CASES
        assert all(set(v) == {"prediction", "cat_surrogates",
                              "cont_surrogates"} for v in got.values())
    _predictions_close(got, want)


@pytest.mark.parametrize("main", [jax_main, cli_main])
def test_train_takes_no_logger_flags(cohort, main):
    with pytest.raises(SystemExit):
        main(["classification_deconfounder", "train",
              *_train_args(cohort, cohort / "unused"),
              "--logger_type", "wandb"])
