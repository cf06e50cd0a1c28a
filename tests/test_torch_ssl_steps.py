"""
The port's self-supervised train steps against the JAX package's, on the
CPU: every two-view method (VICReg, Barlow Twins, SimCLR, SimSiam, BYOL),
VICReg with ``--stop_gradient``, BYOL with the EMA teacher and I-JEPA with
the EMA, each over three steps of ``make_ssl_train_step`` and the train
state (AdamW with the norms and biases not decayed, the EMA shadow).
Seeded numpy inputs and parameters (``random_flax_params``' draw), moved
into the port through ``from_flax``; the networks are
``tests/test_torch_ssl.py``'s (the two-view backbone cut to two stages).

Tolerances, each stated where it is used: a step's loss 1e-5 relative,
its gradients 1e-4 of each leaf's own scale from the JAX step run in f64
(or at most twice the JAX f32 step's distance from it, where f32
cancels; a leaf whose exact gradient is 0, within 1e-4 of the step's
scale or twice JAX's distance), the kept running statistics 1e-6 of
those of the port's own ``view1`` forward and 1e-5 of JAX's; given the
same gradients, the parameters after one AdamW step 1e-5 and the EMA
shadow after three 1e-6 of JAX's; I-JEPA's own train step's losses over
the three steps 1e-4 relative of JAX's. The optimizer is held on the JAX
step's gradients because Adam's first update is the sign of each
gradient element: an element whose gradient is rounding noise (a conv
bias ahead of a training batch norm, 0 in exact arithmetic) moves by the
learning rate either way.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.config import factories as jfactories
from adell_mri_tpu.models.ssl import masking as jmasking
from adell_mri_tpu.train import optim as joptim
from adell_mri_tpu.train import ssl_steps as jsteps
from adell_mri_tpu.train.state import TrainState as JaxTrainState
from adell_mri_torch.config import factories as tfactories
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.layers.adn import pop_batch_stats
from adell_mri_torch.train import optim as toptim
from adell_mri_torch.train import ssl_steps as tsteps
from adell_mri_torch.train.ema import ema_decay_at, ema_update
from adell_mri_torch.train.state import TrainState
from test_torch_ssl import (
    IJEPA_SHAPE,
    TINY,
    _close,
    _ijepa,
    _jax_ijepa,
    _t,
    _views,
)
from test_torch_unet import random_flax_params

LR, WD = 0.01, 1e-3

STEP_CASES = {
    "vicreg": dict(method="vicreg"),
    "vicreg_stop_gradient": dict(method="vicreg", stop_gradient=True),
    "barlow_twins": dict(method="barlow_twins"),
    "simclr": dict(method="simclr"),
    "simsiam": dict(method="simsiam"),
    "byol_ema": dict(method="byol", ema=True),
    "ijepa_ema": dict(method="ijepa", ema=True),
}
N_STEPS = 3
# the steps' backbone: two stages, so that seven JAX steps compile in
# seconds each
STEP_NET = {**TINY, "backbone_args": {
    **TINY["backbone_args"],
    "structure": [[8, 8, 3, 1], [16, 16, 3, 1]],
    "maxpool_structure": [[2, 2, 1], [2, 2, 2]]}}
STEP_VIEW = (16, 16, 8)
EMA = dict(ema_decay=0.9, ema_final_decay=1.0, ema_n_steps=10)


def _from_flax64(tree):
    hi = jax.tree.map(lambda a: a.astype(np.float32), tree)
    lo = jax.tree.map(lambda a, h: (a - h).astype(np.float32), tree, hi)
    lo = from_flax(lo)
    return {k: v.double() + lo[k].double() for k, v in from_flax(hi).items()}


@functools.lru_cache(maxsize=None)
def _jax_step_net():
    jm = jfactories.get_ssl_network("vicreg", STEP_NET)
    x = jnp.asarray(_views(21, shape=STEP_VIEW)[0])
    params = random_flax_params(jm, x, seed=20)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    bs = jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.full(s.shape, float(path[-1].key == "var"),
                                 s.dtype), shapes["batch_stats"])
    return jm, params, bs


def _jax_side(case):
    """(loss_and_metrics, params, variables, batches, port model maker):
    the JAX step and its inputs for ``case``."""
    cfg = STEP_CASES[case]
    if cfg["method"] == "ijepa":
        jm, params, x = _jax_ijepa(20)
        lm = jsteps.make_ijepa_step(jm)
        batches = [{"image": np.random.default_rng(30 + i).uniform(
            size=x.shape).astype(np.float32)} for i in range(N_STEPS)]
        return lm, params, None, batches, lambda: _ijepa(20)[2]
    jm, params, bs = _jax_step_net()
    lm = jsteps.make_two_view_step(
        jm, method=cfg["method"], ema_teacher=cfg.get("ema", False),
        stop_gradient=cfg.get("stop_gradient", False))
    batches = []
    for i in range(N_STEPS):
        v1, v2 = _views(30 + i, shape=STEP_VIEW)
        batches.append({"view1": v1, "view2": v2})

    def port_model():
        tm = tfactories.get_ssl_network("vicreg", STEP_NET)
        tm.load_state_dict(from_flax(params, bs))
        return tm

    return lm, params, {"batch_stats": bs}, batches, port_model


def _ijepa_mask(key):
    return np.asarray(jmasking.block_masking(
        key, [s // 4 for s in IJEPA_SHAPE]))


def _port_state(tm, use_ema):
    return TrainState.create(
        tm, lambda p: toptim.get_optimizer(
            "adamw", LR, weight_decay=WD, params=p,
            exclude_norms_from_decay=True, model=tm),
        with_ema=use_ema, **EMA)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_ssl_step_matches_jax(case):
    """One step's loss, gradients and kept statistics against the JAX
    step; the port's train state given the JAX step's gradients against
    the JAX train state (AdamW with the norms and biases not decayed):
    the parameters after one step within 1e-5 of each leaf's scale and the
    EMA shadow after three within 1e-6; the port's own train step's EMA
    shadow a plain ``ema_update`` of its parameters at ``ema_decay_at``
    of each step (1e-6), and a leaf its loss does not reach (the
    prediction head of a projection method, I-JEPA's target encoder)
    decayed alone, as optax decays a zero gradient. For I-JEPA the port's
    own train step's loss at each of the three steps within 1e-4 relative
    of the JAX step's (``tests/test_torch_ssl_trajectory.py`` holds six
    steps at the factory's width). The two-view methods' own trajectories
    are not held so: a conv bias ahead of a training batch norm has a
    rounding-noise gradient, which Adam's sign-like first updates turn
    into moves of the learning rate (VICReg's third loss reads 1.5e-3
    from JAX's)."""
    cfg = STEP_CASES[case]
    ijepa = cfg["method"] == "ijepa"
    lm, params, variables, batches, port_model = _jax_side(case)
    keys = [jax.random.PRNGKey(40 + i) for i in range(N_STEPS)]
    use_ema = cfg.get("ema", False)
    tx = joptim.get_optimizer("adamw", LR, weight_decay=WD, params=params,
                              exclude_norms_from_decay=True)
    jstate = JaxTrainState.create(None, params, tx, variables=variables,
                                  with_ema=use_ema, **EMA)

    @jax.jit
    def jax_step(state, batch, key):
        # make_ssl_train_step's update, returning the gradients too
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: lm(p, batch, key, ema_params=state.ema_params,
                         variables=state.variables), has_aux=True)(
            state.params)
        new_vars = metrics.pop("_variables", None)
        return (state.apply_gradients(grads, variables=new_vars), loss,
                new_vars, grads)

    tm = port_model()
    tstate = _port_state(tm, use_ema)
    given = _port_state(port_model(), use_ema)
    if ijepa:
        tlm = tsteps.make_ijepa_step(tm)
    else:
        tlm = tsteps.make_two_view_step(
            tm, method=cfg["method"], ema_teacher=use_ema,
            stop_gradient=cfg.get("stop_gradient", False))
    train_step = tsteps.make_ssl_train_step(tlm)
    shadow = {k: v.detach().clone() for k, v in tstate.params.items()}
    # the prediction head of a projection method, I-JEPA's target encoder
    stem = ("target_encoder." if ijepa else "-" if cfg["method"] in (
        "simsiam", "byol") else "pred_")
    unreached = {k: v.detach().clone() for k, v in tstate.params.items()
                 if k.startswith(stem)}

    def port_batch(i):
        b = {k: _t(v) for k, v in batches[i].items()}
        if ijepa:
            b["mask"] = _t(_ijepa_mask(keys[i]))
        return b

    own = []
    for i in range(N_STEPS):
        jb = {k: jnp.asarray(v) for k, v in batches[i].items()}
        before = jstate
        jstate, jl, jvars, jgrads = jax_step(jstate, jb, keys[i])
        if i == 0:
            tl, tmet = tlm(tstate.weights(), port_batch(0),
                           ema_params=tstate.ema_params)
            assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
            names = list(tstate.params)
            tg = torch.autograd.grad(tl, [tstate.params[k] for k in names],
                                     allow_unused=True)
            tg = {k: torch.zeros_like(tstate.params[k]) if g is None else g
                  for k, g in zip(names, tg)}
            _check_gradients(lm, before, jb, keys[0], jgrads, tg)
            if variables:
                _check_kept_statistics(tm, tstate, port_batch(0),
                                       tmet["_variables"], jvars)
        given.apply_gradients(
            from_flax(jax.tree.map(np.asarray, jgrads)),
            variables=from_flax({}, jvars["batch_stats"]) if jvars else None)
        tstate, tmetrics = train_step(tstate, port_batch(i))
        own.append((float(tmetrics["loss"]), float(jl)))
        if use_ema:
            ema_update(shadow, tstate.params, ema_decay_at(i, **{
                "decay": 0.9, "final_decay": 1.0, "n_steps": 10}))
        if i == 0:
            _check_tree(given.params, jstate.params, 1e-5)
            mask = toptim.wd_mask(tm)
            assert bool(unreached) == (stem != "-")
            for k, p0 in unreached.items():
                want = p0 * (1 - LR * WD) if mask[k] else p0
                assert torch.allclose(tstate.params[k].detach(), want,
                                      rtol=1e-6, atol=0), k
    assert tstate.step == given.step == N_STEPS
    if ijepa:
        # the port's own trajectory: each step's loss against JAX's
        for got, want in own:
            assert abs(got - want) <= 1e-4 * abs(want), own
    if use_ema:
        _check_tree(given.ema_params, jstate.ema_params, 1e-6)
        for k, v in shadow.items():
            _close(tstate.ema_params[k], v, 1e-6)
        assert not torch.equal(tstate.ema_params[names[0]],
                               tstate.params[names[0]].detach())


def _check_kept_statistics(tm, tstate, batch, kept, jvars):
    """The statistics the step keeps are those of the student's ``view1``
    forward alone (the port's own training forward of ``view1``: 1e-6 of
    their scale), and the JAX step's (1e-5, the forwards' tolerance)."""
    tm.train()
    with torch.no_grad():
        torch.func.functional_call(tm, tstate.weights(), (batch["view1"],))
    own = pop_batch_stats(tm)
    want = from_flax({}, jvars["batch_stats"])
    assert set(kept) == set(own) == set(want)
    for k, v in want.items():
        _close(kept[k], own[k], 1e-6)
        _close(kept[k], v, 1e-5)


def _check_gradients(lm, state, jb, key, jgrads, tg):
    """Each gradient within 1e-4 of its own scale from the JAX f32 step
    (or, both below 1e-5 of the step's scale, rounding noise on a leaf
    whose exact gradient is 0), or else from the JAX step run in f64
    (computed where needed): within
    1e-4 of the reference's own scale or at most twice as far as the JAX
    f32 step. Where the reference is below 1e-5 of the step's scale the
    leaf is rounding noise (its exact gradient is 0 and f32 cancels): it
    has no scale of its own, so the port's gradient is held within 1e-4
    of the step's scale, or at most twice as far as the JAX f32 step."""
    want = from_flax(jax.tree.map(np.asarray, jgrads))
    assert set(tg) == set(want)
    scale = max(float(g.abs().max()) for g in want.values())
    ref = None
    for k, w in want.items():
        own = float(w.abs().max())
        if own >= 1e-5 * scale and float(
                (tg[k] - w).abs().max()) <= 1e-4 * own:
            continue
        if max(own, float(tg[k].abs().max())) < 1e-5 * scale:
            # both below the noise floor: the leaf's exact gradient is 0
            continue
        if ref is None:
            ref = _f64_gradients(lm, state, jb, key)
        r = ref[k]
        err = float((tg[k].double() - r).abs().max())
        jerr = float((w.double() - r).abs().max())
        own = float(r.abs().max())
        if own < 1e-5 * scale:
            assert err <= max(1e-4 * scale, 2 * jerr), (k, err / scale,
                                                      jerr / scale)
        else:
            assert err <= max(1e-4 * own, 2 * jerr), (k, err / own,
                                                      jerr / own)


def _f64_gradients(lm, state, jb, key):
    """The JAX step's gradients in f64 (the running statistics f32, as in
    both packages), by the port's names."""
    with jax.enable_x64(True):
        f64 = lambda t: None if t is None else jax.tree.map(
            lambda a: jnp.asarray(a, jnp.float64), t)
        grads = jax.jit(jax.grad(
            lambda p, e: lm(p, f64(jb), key, ema_params=e,
                            variables=state.variables)[0]))(
            f64(state.params), f64(state.ema_params))
        return _from_flax64(jax.tree.map(np.asarray, grads))


def _check_tree(got, jtree, tol):
    """``got`` (port names) against the JAX tree, within ``tol`` of each
    leaf's scale."""
    want = from_flax(jax.tree.map(np.asarray, jtree))
    assert set(got) == set(want)
    for k, w in want.items():
        _close(got[k], w, tol)
