"""
The port's ordinal classifier against the JAX package's, on the CPU:
``ordinal_sigmoidal_loss`` (with and without class weights),
``ordinal_prediction_to_class``, ``ordinal_to_class_probs`` (at
unordered thresholds, where the clamp and the renormalisation act),
``OrdNet`` (eval by the running statistics, the score before the
thresholds, a training forward's statistics), the factory's tree for
``classification-cat-resnet.yaml``'s structure, the metrics callback's
ordinal mode and one ``make_classification_step`` step on the ordinal
loss.

Tiny shapes (16x16x8 volumes, widths 8-32), seeded numpy inputs and
parameters moved into the port through ``from_flax``. Tolerances: f32
functions and forwards 1e-5 of the output's scale (1e-6 absolute for
probabilities), the step's as in ``tests/test_torch_vit_classifier.py``
(loss 1e-5, gradients 2e-4, statistics 1e-5).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.config import factories as jfactories
from adell_mri_tpu.eval.callbacks import (
    ClassificationMetricsCallback as JaxCallback,
)
from adell_mri_tpu.models.classification import losses as jlosses
from adell_mri_torch.config import factories as tfactories
from adell_mri_torch.config.parsing import parse_config_cat
from adell_mri_torch.eval.callbacks import ClassificationMetricsCallback
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.classification import losses as tlosses
from adell_mri_torch.models.layers import adn as tadn
from test_torch_vit_classifier import _close, _x, build, step_matches_jax

CONFIGS = Path(__file__).resolve().parents[1] / "sample_configs"
ORD = dict(resnet_structure=[[8, 16, 3, 1], [16, 32, 3, 1]])


def _logits(shape, seed):
    return (2 * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


@pytest.mark.parametrize("n_classes", [2, 3, 5])
def test_ordinal_functions_match_jax(n_classes):
    logits = _logits((7, n_classes - 1), n_classes)
    labels = np.arange(7) % n_classes
    weight = np.linspace(0.5, 2.0, n_classes).astype(np.float32)
    tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    for w in (None, weight):
        want = jlosses.ordinal_sigmoidal_loss(
            jnp.asarray(logits), jnp.asarray(labels), n_classes, weight=w)
        got = tlosses.ordinal_sigmoidal_loss(tl, tlab.float(), n_classes,
                                             weight=w)
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    np.testing.assert_array_equal(
        tlosses.ordinal_prediction_to_class(tl).numpy(),
        np.asarray(jlosses.ordinal_prediction_to_class(jnp.asarray(logits))))
    want = np.asarray(jlosses.ordinal_to_class_probs(jnp.asarray(logits)))
    got = tlosses.ordinal_to_class_probs(tl).numpy()
    assert got.shape == (7, n_classes)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("n_classes", [2, 3, 4])
def test_ordnet_matches_jax(n_classes):
    """Eval logits by the running statistics (``n_classes - 1`` columns),
    the score alone (``return_only_pre_bias``), and a training forward's
    updated statistics."""
    x = _x(b=3, seed=20)
    jm, params, bs, tm = build("ord", ORD, n_classes, x, seed=21,
                               batch_stats=True)
    variables = {"params": params, "batch_stats": bs}
    want = jm.apply(variables, jnp.asarray(x))
    assert want.shape == (3, n_classes - 1)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), want)
        _close(tm(torch.from_numpy(x), return_only_pre_bias=True),
               jm.apply(variables, jnp.asarray(x),
                        return_only_pre_bias=True))
    _, upd = jm.apply(variables, jnp.asarray(x), train=True,
                      mutable=["batch_stats"])
    tm.train()
    with torch.no_grad():
        tm(torch.from_numpy(x))
    got = tadn.pop_batch_stats(tm)
    want = from_flax({}, upd["batch_stats"])
    assert set(got) == set(want)
    for k, w in want.items():
        assert float((got[k] - w).abs().max()) <= 1e-5 * max(
            float(w.abs().max()), 1e-3), k


def test_ordnet_fresh_thresholds_match_jax():
    """flax's own initial thresholds: ``n-1, ..., 1`` scaled by ``1 /
    (n-1)``, the port's at construction."""
    jm = jfactories.get_classification_network("ord", ORD, n_classes=4)
    init = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 8, 1)))
    tm = tfactories.get_classification_network("ord", ORD, n_classes=4)
    for name in ("threshold_bias", "threshold_bias_scale"):
        np.testing.assert_allclose(getattr(tm, name).detach().numpy(),
                                   np.asarray(init["params"][name]))


def test_yaml_tree_matches_jax():
    """``classification-cat-resnet.yaml`` under ``ord``: the factory
    takes its ``resnet_structure`` alone (no batch ensembles, no
    ``res_type``, no pools from the yaml); the port's parameters and
    statistics have the JAX tree's names and shapes."""
    cfg = parse_config_cat(str(CONFIGS / "classification-cat-resnet.yaml"))[
        "network"]
    jm = jfactories.get_classification_network("ord", cfg, n_classes=3)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 32, 1)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = from_flax(zeros["params"], zeros["batch_stats"])
    tm = tfactories.get_classification_network("ord", cfg, n_classes=3)
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
    assert not any("BatchEnsemble" in k for k in got)
    assert "Dense_1.bias" not in got


def test_ordinal_callback_matches_jax():
    """The metrics callback's ordinal mode: class probabilities from the
    cumulative logits, the multiclass metrics; the same values as the JAX
    callback's on the same parameters and batch (1e-5)."""
    x = _x(b=6, seed=30)
    jm, params, _, tm = build("ord", ORD, 3, x, seed=31, batch_stats=True)
    labels = np.asarray([0, 1, 2, 2, 1, 0], np.float32)
    jcb = JaxCallback(jm, n_classes=3, ordinal=True)
    jcb.on_validation_batch(params, {"image": jnp.asarray(x),
                                     "label": jnp.asarray(labels)}, {})
    want = jcb.on_validation_end(params)
    tcb = ClassificationMetricsCallback(tm, n_classes=3, ordinal=True)
    tcb.on_validation_batch(
        dict(tm.state_dict()),
        {"image": torch.from_numpy(x), "label": torch.from_numpy(labels)},
        {})
    got = tcb.on_validation_end(None)
    assert set(got) == set(want) and "V_f1_c2" in got
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5, (k, got[k], v)


@pytest.mark.parametrize("n_classes", [2, 4])
def test_ordinal_step_matches_jax(n_classes):
    """One training step on the ordinal sigmoidal loss, as ``classification
    train`` builds it for ``ord``; the step's accuracy is the JAX step's
    (for more than two classes, the argmax over the ``n - 1`` cumulative
    logits against the class)."""
    x = _x(b=4, seed=40)
    jm, params, bs, tm = build("ord", ORD, n_classes, x, seed=41,
                               batch_stats=True)
    y = (np.arange(4) % n_classes).astype(np.float32)
    step_matches_jax(
        jm, params, bs, tm, {"image": x, "label": y}, n_classes,
        loss_fn=lambda lg, t: jlosses.ordinal_sigmoidal_loss(
            lg, t, n_classes),
        tloss_fn=lambda lg, t: tlosses.ordinal_sigmoidal_loss(
            lg, t, n_classes))
