"""
The port's ensembles against the JAX package's, on the CPU.

``GenericEnsemble`` over two tiny CatNets (batch ensembles of 2, batch
norm), each built headless as the JAX ensemble creates it (it calls its
members with ``return_features``, so flax creates no head):
``from_flax`` maps the tree (``networks_{i}``, ``Dense_0``, ``Dense_1``);
eval logits with running statistics and with the parameters alone (each
batch's statistics, the JAX ensemble CLI's forward) within 1e-5 of the
scale, for concat and mean fusion; ``AveragingEnsemble`` the same. The
train step applying the parameters alone, as the JAX ensemble CLI's step
does, with the members injected: loss 1e-5 relative, each gradient 2e-4
of its own scale, and no statistics returned. The JAX step runs on
batch-ensemble members (its step hands flax an ``ensemble`` stream), so
the port trains them too. Members whose JAX modules take no
``return_features`` are refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.config import factories as jfactories
from adell_mri_tpu.models.classification import losses as jlosses
from adell_mri_tpu.models.classification.nets import (
    AveragingEnsemble as JaxAveraging,
    GenericEnsemble as JaxGeneric,
)
from adell_mri_tpu.train import steps as jsteps
from adell_mri_torch.config import factories as tfactories
from adell_mri_torch.entrypoints.classification.train import (
    parameters_alone,
)
from adell_mri_torch.entrypoints.classification_ensemble.train import (
    ensemble_network,
)
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.classification import losses as tlosses
from adell_mri_torch.models.classification.nets import (
    AveragingEnsemble,
    GenericEnsemble,
)
from adell_mri_torch.models.layers import adn as tadn
from adell_mri_torch.train import steps as tsteps
from test_torch_classification import (
    SHAPE,
    TINY,
    _close,
    _Draws,
    _trained_stats,
)
from test_torch_unet import random_flax_params

OTHER = {**TINY, "resnet_structure": [[8, 8, 3, 1], [8, 24, 3, 1]]}


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(60).uniform(
        size=(4,) + SHAPE + (1,)).astype(np.float32)


def _pair(x, fusion="concat", n_classes=2, seed=61, configs=(TINY, OTHER)):
    """A JAX GenericEnsemble with seeded weights and trained statistics,
    and the port's (``ensemble_network``: headless members) with the
    same."""
    members = [jfactories.get_classification_network("cat", cfg,
                                                     n_classes=n_classes)
               for cfg in configs]
    jm = JaxGeneric(networks=members, n_classes=n_classes, fusion=fusion)
    params = jax.tree.map(jnp.asarray,
                          random_flax_params(jm, jnp.asarray(x), seed=seed))
    bs = _trained_stats(jm, params, x, steps=2)
    tm = ensemble_network("cat", configs, n_classes)
    if fusion != "concat":
        tm = GenericEnsemble([tm.networks_0, tm.networks_1],
                             n_classes=n_classes, fusion=fusion)
    tm.load_state_dict(from_flax(params, bs))
    return jm, params, bs, tm


# mean fusion needs members of one width
@pytest.mark.parametrize("fusion, n_classes, configs", [
    ("concat", 2, (TINY, OTHER)), ("mean", 3, (TINY, TINY))])
def test_generic_ensemble_forward_matches_jax(x, fusion, n_classes,
                                              configs):
    jm, params, bs, tm = _pair(x, fusion, n_classes, configs=configs)
    assert {k.split(".")[0] for k in tm.state_dict()} == {
        "networks_0", "networks_1", "Dense_0", "Dense_1"}
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        with tadn.batch_statistics_mode(tm):
            alone = tm(torch.from_numpy(x))
    _close(got, jm.apply({"params": params, "batch_stats": bs},
                         jnp.asarray(x)), 1e-5)
    _close(alone, jm.apply({"params": params}, jnp.asarray(x)), 1e-5)


def test_averaging_ensemble_matches_jax(x):
    members = [jfactories.get_classification_network("cat", cfg)
               for cfg in (TINY, OTHER)]
    jm = JaxAveraging(networks=members)
    params = jax.tree.map(jnp.asarray,
                          random_flax_params(jm, jnp.asarray(x), seed=63))
    bs = _trained_stats(jm, params, x, steps=2)
    tm = AveragingEnsemble([tfactories.get_classification_network("cat", c)
                            for c in (TINY, OTHER)])
    tm.load_state_dict(from_flax(params, bs))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    _close(got, jm.apply({"params": params, "batch_stats": bs},
                         jnp.asarray(x)), 1e-5)


def test_generic_ensemble_step_matches_jax(monkeypatch, x):
    """The JAX ensemble CLI's step: ``make_classification_step`` with no
    ``variables`` (the parameters alone; batch-ensemble members drawn
    from its ``ensemble`` stream, injected here) against the port's
    ``parameters_alone`` step."""
    jm, params, bs, tm = _pair(x, seed=64)
    rng = np.random.default_rng(65)
    members = [rng.integers(0, 2, 4).astype(np.int32) for _ in range(4)]
    _Draws(monkeypatch, members=members)
    y = np.asarray([0, 1, 1, 0], np.float32)
    jlm = jsteps.make_classification_step(jm, jlosses.binary_logistic_loss)
    (jl, jmet), jgrads = jax.value_and_grad(jlm, has_aux=True)(
        params, {"image": jnp.asarray(x), "label": jnp.asarray(y)},
        jax.random.PRNGKey(3))
    assert "_variables" not in jmet
    tlm = parameters_alone(tsteps.make_classification_step(
        tm, tlosses.binary_logistic_loss), tm, train=True)
    tparams = dict(tm.named_parameters())
    tl, tmet = tlm({**tparams, **tadn.batch_stats(tm)},
                   {"image": torch.from_numpy(x),
                    "label": torch.from_numpy(y)})
    assert "_variables" not in tmet
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    names = list(tparams)
    tgrads = dict(zip(names, torch.autograd.grad(
        tl, [tparams[k] for k in names])))
    want = from_flax(jgrads)
    assert set(tgrads) == set(want)
    scale = max(float(g.abs().max()) for g in want.values())
    for k, g in want.items():
        own = float(g.abs().max())
        if own < 1e-5 * scale:
            assert float(tgrads[k].abs().max()) < 1e-5 * scale, k
            continue
        assert float((tgrads[k] - g).abs().max()) <= 2e-4 * own, k


@pytest.mark.parametrize("net_type", ["ord", "unet", "vit", "factorized_vit"])
def test_members_without_features_are_refused(net_type):
    with pytest.raises(ValueError, match="return_features"):
        ensemble_network(net_type, [{}], 2)
