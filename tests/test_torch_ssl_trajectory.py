"""
I-JEPA's training trajectory in the port against the JAX package's, on
the CPU: the factory's default network (patch 4, embedding 192, 4 blocks
of 4 heads, predictor 96 x 2) with flax's own initialisation moved into
the port through ``from_flax``, on two seeded 32x32x16 volumes a step
(8x8x4 = 256 tokens), six steps of ``make_ssl_train_step`` with AdamW
(decay 0.001, the norms and biases not decayed) and the EMA teacher
(0.996 ramped to 1 over 100 steps), each step's mask the one JAX drew.

The loss of every step is held within 1e-3 relative of the JAX step's.
The parameters are not compared leaf by leaf: Adam's first updates are
close to each gradient element's sign, so an element whose gradient is
rounding noise moves by the learning rate either way. The key norm's
bias is such a leaf: a constant added to a query's scores leaves its
softmax as it is, so its exact gradient is 0. The losses read every
parameter, so six of them in agreement witness the whole trajectory.

At the rate of ``ssl-resnet.yaml`` (0.01) the JAX step's own loss rises
(pinned: a later step's loss above three times the first); at 1e-4 it
falls at every step (pinned too). Run with ``-s`` to print both
trajectories.
"""

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
from adell_mri_torch.train import optim as toptim
from adell_mri_torch.train import ssl_steps as tsteps
from adell_mri_torch.train.state import TrainState

SHAPE = (32, 32, 16)
BATCH = 2
N_STEPS = 6
WD = 1e-3
EMA = dict(ema_decay=0.996, ema_final_decay=1.0, ema_n_steps=100)


def _jax_trajectory(jm, params, lr, batches, keys):
    tx = joptim.get_optimizer("adamw", lr, weight_decay=WD, params=params,
                              exclude_norms_from_decay=True)
    state = JaxTrainState.create(None, params, tx, with_ema=True, **EMA)
    lm = jsteps.make_ijepa_step(jm)

    @jax.jit
    def step(state, batch, key):
        (loss, _), grads = jax.value_and_grad(
            lambda p: lm(p, batch, key, ema_params=state.ema_params),
            has_aux=True)(state.params)
        return state.apply_gradients(grads), loss

    losses = []
    for batch, key in zip(batches, keys):
        state, loss = step(state, {"image": jnp.asarray(batch)}, key)
        losses.append(float(loss))
    return losses


def _port_trajectory(params, lr, batches, masks):
    tm = tfactories.get_ssl_network("ijepa", {}, image_size=SHAPE)
    tm.load_state_dict(from_flax(params))
    state = TrainState.create(
        tm, lambda p: toptim.get_optimizer(
            "adamw", lr, weight_decay=WD, params=p,
            exclude_norms_from_decay=True, model=tm),
        with_ema=True, **EMA)
    train_step = tsteps.make_ssl_train_step(tsteps.make_ijepa_step(tm))
    losses = []
    for batch, mask in zip(batches, masks):
        state, metrics = train_step(state, {
            "image": torch.from_numpy(batch),
            "mask": torch.from_numpy(mask)})
        losses.append(float(metrics["loss"]))
    return losses


@pytest.mark.parametrize("lr", [0.01, 1e-4], ids=["yaml_lr", "lr_1e-4"])
def test_ijepa_trajectory_matches_jax(lr):
    jm = jfactories.get_ssl_network("ijepa", {})
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "masking": jax.random.PRNGKey(1)},
                     jnp.zeros((BATCH,) + SHAPE + (1,)),
                     rng=jax.random.PRNGKey(0))["params"]
    batches = [np.random.default_rng(30 + i).uniform(
        size=(BATCH,) + SHAPE + (1,)).astype(np.float32)
        for i in range(N_STEPS)]
    keys = [jax.random.PRNGKey(40 + i) for i in range(N_STEPS)]
    grid = [s // 4 for s in SHAPE]
    masks = [np.asarray(jmasking.block_masking(k, grid), np.float32)
             for k in keys]
    want = _jax_trajectory(jm, params, lr, batches, keys)
    got = _port_trajectory(params, lr, batches, masks)
    print(f"\nI-JEPA at lr {lr}: JAX losses {want}\n"
          f"                  port losses {got}")
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-3 * abs(w), (got, want)
    if lr == 0.01:
        assert max(want[2:]) > 3 * want[0], want
    else:
        assert all(b < a for a, b in zip(want, want[1:])), want
