"""
The port's VICRegL, DINO (with local crops), iBOT and MAE train steps
against the JAX package's, on the CPU, each over three steps of
``make_ssl_train_step`` and the train state: AdamW with the norms and
biases not decayed, DINO's and iBOT's EMA teacher and centres. The JAX
draws go into the port: iBOT's block masks (as the JAX step draws them
from its key), MAE's masking noise, DINO's local crops and VICRegL's view
matrices (the identity and a shift of 2 voxels, so that many nearest
distances tie and the selection follows JAX's order of ties).

Tolerances, as in ``tests/test_torch_ssl_steps.py``: a step's loss 1e-5
relative and its new centres 1e-6 of the JAX step's, at each of the three
steps on the JAX state before it; the first step's gradients 1e-4 of each
leaf's scale from the JAX step run in f64, or at most twice the JAX f32
step's distance from it; the state given the JAX step's gradients:
parameters after one step 1e-5 and the EMA shadow after three 1e-6 of
JAX's. The port's own train step: each of its three losses within 1e-4
relative of JAX's for the ViT methods (no batch norm, so no rounding-noise
gradient for Adam's sign-like first updates to turn into moves of the
learning rate), and VICRegL's running statistics untouched, as the JAX
step applies the parameters alone.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.config import factories as jfactories
from adell_mri_tpu.train import optim as joptim
from adell_mri_tpu.train import ssl_steps as jsteps
from adell_mri_tpu.train.state import TrainState as JaxTrainState
from adell_mri_torch.config import factories as tfactories
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.train import ssl_steps as tsteps
from adell_mri_torch.train.ema import ema_decay_at, ema_update
from test_torch_ssl import _close, _t, _views
from test_torch_ssl_methods import LOCAL, VIEW, VIT, _draw_params, _images
from test_torch_ssl_steps import (
    EMA,
    LR,
    N_STEPS,
    STEP_NET,
    STEP_VIEW,
    WD,
    _check_gradients,
    _check_tree,
    _jax_step_net,
    _port_state,
)

STEP_VIT = {**VIT, "n_blocks": 1}
N_LOCAL = 2
CENTRES = {"dino": ("dino_center",),
           "ibot": ("ibot_center_global", "ibot_center_mask")}
EMA_METHODS = ("dino", "ibot")


@functools.lru_cache(maxsize=None)
def _jax_vit(method):
    jm = jfactories.get_ssl_network(method, STEP_VIT)
    x = jnp.asarray(_images(21, b=4))
    rngs = {"params": jax.random.PRNGKey(0),
            "masking": jax.random.PRNGKey(1)}
    kw = {"ibot": dict(mask=True), "mae": dict(rng=jax.random.PRNGKey(0))}
    shapes = jax.eval_shape(
        lambda: jm.init(rngs, x, **kw.get(method, {})))["params"]
    return jm, _draw_params(shapes, 20)


def _vicregl_batch(seed):
    v1, v2 = _views(seed, shape=STEP_VIEW)
    shift = np.eye(4, dtype=np.float32)
    shift[0, 3] = 2.0
    return {"view1": v1, "view2": v2,
            "view1_mat": np.tile(np.eye(4, dtype=np.float32), (4, 1, 1)),
            "view2_mat": np.tile(shift, (4, 1, 1))}


def _jax_side(method):
    """(JAX loss_and_metrics, params, variables, batches, port model)."""
    if method == "vicregl":
        jm = jfactories.get_ssl_network("vicregl", STEP_NET)
        _, params, bs = _jax_step_net()
        params = {k: v for k, v in params.items()
                  if not k.startswith("pred_")}
        batches = [_vicregl_batch(30 + i) for i in range(N_STEPS)]
        lm = jsteps.make_vicregl_step(jm)

        def port_model():
            tm = tfactories.get_ssl_network("vicregl", STEP_NET)
            tm.load_state_dict(from_flax(params, bs))
            return tm

        return lm, params, {"batch_stats": bs}, batches, port_model
    jm, params = _jax_vit(method)
    out_dim = STEP_VIT["out_dim"]
    variables = {k: jnp.zeros(out_dim) for k in CENTRES.get(method, ())}
    batches = []
    for i in range(N_STEPS):
        if method == "mae":
            batches.append({"image": _images(30 + i, b=4)})
            continue
        v1, v2 = _images(30 + i, b=4), _images(40 + i, b=4)
        batch = {"view1": v1, "view2": v2}
        if method == "dino":
            batch["local_crops"] = np.stack(
                [_images(50 + 2 * i + c, b=4, shape=LOCAL)
                 for c in range(N_LOCAL)], axis=1)
        batches.append(batch)
    lm = {"dino": jsteps.make_dino_step, "ibot": jsteps.make_ibot_step,
          "mae": jsteps.make_mae_step}[method](jm)

    def port_model():
        tm = tfactories.get_ssl_network(method, STEP_VIT, image_size=VIEW)
        tm.load_state_dict(from_flax(params))
        return tm

    return lm, params, variables or None, batches, port_model


@functools.lru_cache(maxsize=None)
def _ibot_masks():
    """The masks the JAX iBOT draws for a view from a key, as its step
    keys them."""
    jm, params = _jax_vit("ibot")
    return jax.jit(lambda x, r: jm.apply(
        {"params": params}, x, mask=True, train=True,
        rngs={"dropout": r, "masking": jax.random.fold_in(r, 7)})[2])


def _port_draws(method, batch, key):
    """The JAX step's draws from ``key`` as the port's batch keys: iBOT's
    masks of each view, MAE's masking noise."""
    if method == "ibot":
        return {f"masks{name}": _t(_ibot_masks()(
            jnp.asarray(batch[f"view{name}"]), r))
            for name, r in zip(("1", "2"), jax.random.split(key))}
    if method == "mae":
        n = int(np.prod([s // 4 for s in VIEW]))
        return {"noise": _t(jax.random.uniform(
            key, (batch["image"].shape[0], n)))}
    return {}


def _port_weights(jstate, like):
    """The JAX state's parameters and variables by the port's names (the
    running statistics and the centres), as ``like.weights()`` holds
    them."""
    variables = dict(jstate.variables or {})
    bs = variables.pop("batch_stats", None)
    out = from_flax(jax.tree.map(np.asarray, jstate.params),
                    None if bs is None else jax.tree.map(np.asarray, bs))
    out.update({k: _t(v) for k, v in variables.items()})
    assert set(out) == set(like.weights())
    return out


def _with_centres(state, centres):
    state.variables.update({k: torch.from_numpy(np.array(v))
                            for k, v in centres.items()})
    return state


@pytest.mark.parametrize("method", ["vicregl", "dino", "ibot", "mae"])
def test_new_ssl_step_matches_jax(method):
    """One step's loss and gradients against the JAX step; three steps of
    the port's state given the JAX gradients (parameters, EMA shadow,
    each step's loss and centres), and three of the port's own train
    step (each loss for the ViT methods; the EMA shadow a plain
    ``ema_update`` at ``ema_decay_at``; VICRegL's statistics as they
    were)."""
    lm, params, variables, batches, port_model = _jax_side(method)
    keys = [jax.random.PRNGKey(60 + i) for i in range(N_STEPS)]
    use_ema = method in EMA_METHODS
    tx = joptim.get_optimizer("adamw", LR, weight_decay=WD, params=params,
                              exclude_norms_from_decay=True)
    jstate = JaxTrainState.create(None, params, tx, variables=variables,
                                  with_ema=use_ema, **EMA)

    @jax.jit
    def jax_step(state, batch, key):
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: lm(p, batch, key, ema_params=state.ema_params,
                         variables=state.variables), has_aux=True)(
            state.params)
        new_vars = metrics.pop("_variables", None)
        return (state.apply_gradients(grads, variables=new_vars), loss,
                new_vars, grads)

    centres = {k: v for k, v in (variables or {}).items()
               if k in CENTRES.get(method, ())}
    tm = port_model()
    tstate = _with_centres(_port_state(tm, use_ema), centres)
    given = _with_centres(_port_state(port_model(), use_ema), centres)
    stats0 = {k: v.clone() for k, v in tstate.variables.items()
              if k not in tsteps.CENTRES}
    tlm = {"vicregl": tsteps.make_vicregl_step,
           "dino": tsteps.make_dino_step, "ibot": tsteps.make_ibot_step,
           "mae": tsteps.make_mae_step}[method](tm)
    train_step = tsteps.make_ssl_train_step(tlm)
    shadow = {k: v.detach().clone() for k, v in tstate.params.items()}
    own = []
    for i in range(N_STEPS):
        jb = {k: jnp.asarray(v) for k, v in batches[i].items()}
        pb = {k: _t(v) for k, v in batches[i].items()}
        pb.update(_port_draws(method, batches[i], keys[i]))
        before = jstate
        jstate, jl, jvars, jgrads = jax_step(jstate, jb, keys[i])
        # the port's step on the JAX state before this step
        weights = {k: v.requires_grad_() for k, v in _port_weights(
            before, given).items()}
        gl, gmet = tlm(weights, pb, ema_params=None if not use_ema
                       else from_flax(jax.tree.map(np.asarray,
                                                   before.ema_params)))
        assert abs(float(gl) - float(jl)) <= 1e-5 * abs(float(jl)), i
        for k in CENTRES.get(method, ()):
            _close(gmet["_variables"][k], jvars[k], 1e-6)
        if i == 0:
            names = list(given.params)
            tg = torch.autograd.grad(gl, [weights[k] for k in names],
                                     allow_unused=True)
            tg = {k: torch.zeros_like(weights[k]) if g is None else g
                  for k, g in zip(names, tg)}
            _check_gradients(lm, before, jb, keys[0], jgrads, tg)
        given.apply_gradients(
            from_flax(jax.tree.map(np.asarray, jgrads)),
            variables={k: _t(jvars[k]) for k in CENTRES.get(method, ())})
        if i == 0:
            _check_tree(given.params, jstate.params, 1e-5)
        tstate, tmetrics = train_step(tstate, pb)
        own.append((float(tmetrics["loss"]), float(jl)))
        if use_ema:
            ema_update(shadow, tstate.params, ema_decay_at(i, **{
                "decay": 0.9, "final_decay": 1.0, "n_steps": 10}))
    assert tstate.step == given.step == N_STEPS
    if method == "vicregl":
        assert set(tstate.variables) == set(stats0)
        for k, v in stats0.items():
            assert torch.equal(tstate.variables[k], v), k
    else:
        for got, want in own:
            assert abs(got - want) <= 1e-4 * abs(want), own
    for k in CENTRES.get(method, ()):
        assert float(tstate.variables[k].abs().max()) > 0
    if use_ema:
        _check_tree(given.ema_params, jstate.ema_params, 1e-6)
        for k, v in shadow.items():
            _close(tstate.ema_params[k], v, 1e-6)
