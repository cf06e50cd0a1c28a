"""
The port's Gaussian-process head against the JAX package's, on the CPU.

``GaussianProcessLayer`` given the same features, its random Fourier
features (``w``, ``b``: the JAX layer's draws from ``PRNGKey(0)`` and
``PRNGKey(1)``, computed here with the JAX expression and handed to
``from_flax``) and its ``beta`` kernel: logits and phi within 1e-5 of
their scale. ``fit_covariance`` within 1e-5 of the scale against the JAX
function in f32, and both within 1e-5 of an f64 inverse;
``predictive_logits`` 1e-6. CatNet with ``gaussian_process`` through
``from_flax``: the yaml's tree, eval logits and phi (1e-5), and the train
step with the ensemble members and dropout masks injected (loss 1e-5
relative, each gradient 2e-4 of its own scale). The params-alone forwards
of the JAX CLI's covariance fit (B=4: each batch's statistics) and of its
calibration (B=1: one sample's statistics in the convs, (0, 1) in the
head's 1-d norms) are pinned on both sides, and differ from the running
statistics' forward that test and predict serve.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.config import factories as jfactories
from adell_mri_tpu.models.classification import losses as jlosses
from adell_mri_tpu.models.layers import gaussian_process as jgp
from adell_mri_tpu.train import steps as jsteps
from adell_mri_torch.config import factories as tfactories
from adell_mri_torch.config.parsing import parse_config_cat
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.classification import losses as tlosses
from adell_mri_torch.models.layers import adn as tadn
from adell_mri_torch.models.layers import gaussian_process as tgp
from adell_mri_torch.train import steps as tsteps
from test_torch_classification import (
    SHAPE,
    TINY,
    YAML,
    _close,
    _Draws,
    _trained_stats,
)
from test_torch_unet import random_flax_params

GP_TINY = {**TINY, "gaussian_process": True}


def jax_gp_features(in_features, n=256, length_scale=2.0):
    """The JAX layer's random Fourier features, by its own expression."""
    w = jax.random.normal(jax.random.PRNGKey(0), (in_features, n))
    b = jax.random.uniform(jax.random.PRNGKey(1), (n,), maxval=2 * jnp.pi)
    return np.asarray(w / length_scale), np.asarray(b)


def gp_in_features(params):
    """The GP head's input width: the last hidden Dense layer's output."""
    last = max((k for k in params if k.startswith("Dense_")),
               key=lambda k: int(k.split("_")[1]))
    return params[last]["kernel"].shape[-1]


def gp_catnet_pair(n_classes, x, seed=40, config=GP_TINY):
    """A JAX GP CatNet with seeded weights and trained statistics, and the
    port's with the same weights, statistics and random features."""
    jm = jfactories.get_classification_network("cat", config,
                                               n_classes=n_classes)
    params = jax.tree.map(jnp.asarray,
                          random_flax_params(jm, jnp.asarray(x), seed=seed))
    bs = _trained_stats(jm, params, x, steps=3)
    tm = tfactories.get_classification_network("cat", config,
                                               n_classes=n_classes)
    tm.load_state_dict(from_flax(
        params, bs, gp_features=jax_gp_features(gp_in_features(params))))
    return jm, params, bs, tm


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(41).uniform(
        size=(4,) + SHAPE + (1,)).astype(np.float32)


def test_gp_layer_matches_jax():
    feats = np.random.default_rng(42).normal(size=(5, 24)).astype(np.float32)
    jl = jgp.GaussianProcessLayer(3)
    params = random_flax_params(jl, jnp.asarray(feats), seed=43)
    want, inter = jl.apply({"params": params}, jnp.asarray(feats),
                           mutable=["intermediates"])
    want_phi = jax.tree.leaves(inter)[0]
    tl = tgp.GaussianProcessLayer(24, 3)
    state = from_flax({"gp": params}, gp_features=jax_gp_features(24))
    tl.load_state_dict({k[3:]: v for k, v in state.items()})
    with torch.no_grad():
        got, phi = tl(torch.from_numpy(feats), return_phi=True)
    _close(got, want, 1e-5)
    _close(phi, want_phi, 1e-5)
    # bf16 features promote against the f32 random features: f32 out
    with torch.no_grad():
        got16 = tl(torch.from_numpy(feats).to(torch.bfloat16))
    assert got16.dtype == torch.float32


def test_fresh_layer_draws_are_seeded():
    a, b = tgp.GaussianProcessLayer(8, 1), tgp.GaussianProcessLayer(8, 1)
    assert torch.equal(a.w, b.w) and torch.equal(a.b, b.b)
    assert a.w.shape == (8, 256) and float(a.b.min()) >= 0.0
    assert float(a.b.max()) < 2 * math.pi
    assert set(a.state_dict()) == {"w", "b", "beta.weight"}


def test_fit_covariance_and_predictive_logits_match_jax():
    """f32 against the JAX f32 function and an f64 inverse (the precision
    matrix's eigenvalues lie in [1, 1 + |Phi|^2], so f32 loses little)."""
    rng = np.random.default_rng(44)
    phis = (math.sqrt(2 / 256) * np.cos(rng.normal(size=(64, 256)) * 3)
            ).astype(np.float32)
    want = np.asarray(jgp.fit_covariance(jnp.asarray(phis)))
    got = tgp.fit_covariance(torch.from_numpy(phis))
    exact = tgp.fit_covariance(torch.from_numpy(phis).double())
    _close(got, want, 1e-5)
    _close(exact, want, 1e-5)
    _close(got, exact.numpy(), 1e-5)
    logits = rng.normal(size=(64, 3)).astype(np.float32)
    want_l = jgp.predictive_logits(jnp.asarray(logits), jnp.asarray(phis),
                                   jnp.asarray(want))
    got_l = tgp.predictive_logits(torch.from_numpy(logits),
                                  torch.from_numpy(phis),
                                  torch.from_numpy(want))
    _close(got_l, want_l, 1e-6)
    # a zero covariance leaves the logits as they are
    zero = tgp.predictive_logits(torch.from_numpy(logits),
                                 torch.from_numpy(phis),
                                 torch.zeros(256, 256))
    assert torch.equal(zero, torch.from_numpy(logits))


def test_yaml_tree_with_gp_matches_jax():
    """``classification-cat-resnet.yaml`` with ``gaussian_process: true``:
    the JAX tree's names and shapes, ``gp/beta`` in place of the output
    Dense layer, plus the random features."""
    net = {**parse_config_cat(str(YAML))["network"],
           "gaussian_process": True}
    jm = jfactories.get_classification_network("cat", net)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 16, 1)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = from_flax(
        zeros["params"], zeros["batch_stats"],
        gp_features=jax_gp_features(gp_in_features(zeros["params"])))
    got = tfactories.get_classification_network("cat", net).state_dict()
    assert set(got) == set(want)
    assert {"gp.w", "gp.b", "gp.beta.weight"} <= set(got)
    assert "Dense_3.weight" not in got
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
    with pytest.raises(ValueError, match="gp_features"):
        from_flax(zeros["params"], zeros["batch_stats"])


@pytest.mark.parametrize("n_classes", [2, 3])
def test_gp_catnet_forward_matches_jax(x, n_classes):
    """Eval with running statistics: logits and phi 1e-5 of the scale."""
    jm, params, bs, tm = gp_catnet_pair(n_classes, x)
    want, inter = jm.apply({"params": params, "batch_stats": bs},
                           jnp.asarray(x), mutable=["intermediates"])
    want_phi = jax.tree.leaves(inter)[0]
    with torch.no_grad():
        got, phi = tm.eval()(torch.from_numpy(x), return_phi=True)
        plain = tm(torch.from_numpy(x))
    assert got.shape == (4, 1 if n_classes == 2 else 3)
    _close(got, want, 1e-5)
    _close(phi, want_phi, 1e-5)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("n_classes", [2, 3])
def test_gp_catnet_step_matches_jax(monkeypatch, x, n_classes):
    """``make_classification_step`` in training with the members and the
    head's dropout masks injected: loss 1e-5 relative, every gradient
    (``gp/beta`` included) 2e-4 of its own scale, statistics 1e-5."""
    jm, params, bs, tm = gp_catnet_pair(n_classes, x, seed=45)
    rng = np.random.default_rng(46)
    members = [rng.integers(0, 2, 4).astype(np.int32) for _ in range(2)]
    masks = [rng.uniform(size=(4, 16)) < 0.9 for _ in range(3)]
    _Draws(monkeypatch, members=members, masks=masks)
    if n_classes == 2:
        y = np.asarray([0, 1, 1, 0], np.float32)
        jloss, tloss = jlosses.binary_logistic_loss, \
            tlosses.binary_logistic_loss
    else:
        y = np.asarray([0, 2, 1, 2], np.float32)
        jloss, tloss = jlosses.cross_entropy_loss, tlosses.cross_entropy_loss
    jlm = jsteps.make_classification_step(jm, jloss, n_classes=n_classes)
    (jl, jmet), jgrads = jax.value_and_grad(jlm, has_aux=True)(
        params, {"image": jnp.asarray(x), "label": jnp.asarray(y)},
        jax.random.PRNGKey(2), variables={"batch_stats": bs})
    tlm = tsteps.make_classification_step(tm, tloss, n_classes=n_classes)
    tparams = dict(tm.named_parameters())
    tl, tmet = tlm({**tparams, **tadn.batch_stats(tm)},
                   {"image": torch.from_numpy(x),
                    "label": torch.from_numpy(y)})
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    want_stats = from_flax({}, jmet["_variables"]["batch_stats"])
    for k, w in want_stats.items():
        g = tmet["_variables"][k]
        assert float((g - w).abs().max()) <= 1e-5 * max(
            float(w.abs().max()), 1e-3), k
    names = list(tparams)
    tgrads = dict(zip(names, torch.autograd.grad(
        tl, [tparams[k] for k in names])))
    want = from_flax(jgrads, gp_features=jax_gp_features(
        gp_in_features(params)))
    want = {k: v for k, v in want.items() if k not in ("gp.w", "gp.b")}
    assert set(tgrads) == set(want) and "gp.beta.weight" in tgrads
    scale = max(float(g.abs().max()) for g in want.values())
    for k, g in want.items():
        own = float(g.abs().max())
        if own < 1e-5 * scale:
            # a bias ahead of a training batch norm: zero up to rounding
            assert float(tgrads[k].abs().max()) < 1e-5 * scale, k
            continue
        assert float((tgrads[k] - g).abs().max()) <= 2e-4 * own, k


def test_params_alone_forwards_are_pinned(x):
    """The JAX CLI fits the covariance and calibrates with the parameters
    alone (no ``batch_stats``): its covariance-fit forward at B=4 takes
    each batch's statistics, its calibration forward at B=1 one sample's
    in the convs and (0, 1) in the head's 1-d norms. The port's
    ``batch_statistics_mode`` forward computes the same function: held
    against its own f64 run (1e-5 of the scale), with the JAX logits
    within 5e-5 of that f64 run (at B=4 the JAX f32 forward lies 1.5e-5
    of the scale from it, the port's 6.7e-6: a batch variance over few
    voxels cancels), and phi of both within 1e-4 of the f64 phi (the
    cosine's argument sums 16 features times weights of about 0.5: the
    port's phi lies 2.3e-5 of its scale from f64, JAX's 7.2e-5). Both
    differ from the running statistics' forward that test and predict
    serve."""
    jm, params, bs, tm = gp_catnet_pair(2, x, seed=47)
    tm.eval()
    t64 = copy.deepcopy(tm).double()
    for xb in (x, x[:1]):
        want, inter = jm.apply({"params": params}, jnp.asarray(xb),
                               mutable=["intermediates"])
        served = jm.apply({"params": params, "batch_stats": bs},
                          jnp.asarray(xb))
        with torch.no_grad(), tadn.batch_statistics_mode(tm):
            got, phi = tm(torch.from_numpy(xb), return_phi=True)
        with torch.no_grad(), tadn.batch_statistics_mode(t64):
            exact, exact_phi = t64(torch.from_numpy(xb).double(),
                                   return_phi=True)
        with torch.no_grad():
            running = tm(torch.from_numpy(xb))
        _close(got, exact.numpy(), 1e-5)
        _close(np.asarray(want), exact.numpy(), 5e-5)
        _close(phi, exact_phi.numpy(), 1e-4)
        _close(jax.tree.leaves(inter)[0], exact_phi.numpy(), 1e-4)
        _close(running, served, 1e-5)
        assert float(np.abs(np.asarray(want) - np.asarray(served)).max()) \
            > 1e-3
