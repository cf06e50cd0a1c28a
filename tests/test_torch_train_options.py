"""
The port's training options against the JAX package's, on the CPU.

``ema_decay_at`` and ``ema_update`` (EMA and SWA) within 1e-7 of the JAX
functions, and the SWA shadow of a few optimizer steps within 1e-6 (the
optimizer's own parity tolerance); early stopping's epoch count equal to
JAX's ``TrainLoop`` on the same metric sequence; the NaN guard raising
and writing its dump; resume restoring the saved state bit-equal and
continuing the epoch count and the learning rate (not a bit-equal
continuation: the loop's generator is seeded afresh, as in the JAX
package).
"""

import types

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adell_mri_tpu.train import ema as jema
from adell_mri_tpu.train import optim as joptim
from adell_mri_tpu.train import schedules as jsched
from adell_mri_tpu.train.loop import TrainLoop as JaxTrainLoop
from adell_mri_tpu.train.nan_guard import NaNGuard as JaxNaNGuard
from adell_mri_tpu.train.state import TrainState as JaxTrainState
from adell_mri_torch.train import ema as tema
from adell_mri_torch.train import optim as toptim
from adell_mri_torch.train import schedules as tsched
from adell_mri_torch.train.checkpoints import CheckpointManager
from adell_mri_torch.train.loop import TrainLoop
from adell_mri_torch.train.nan_guard import NaNGuard
from adell_mri_torch.train.state import TrainState

TOL = 1e-7


@pytest.mark.parametrize(
    "decay,final,n_steps",
    [(0.99, None, None), (0.9, 0.999, 100), (0.999, 0.9, 50),
     (0.5, 0.99, 7)],
)
def test_ema_decay_at_matches_jax(decay, final, n_steps):
    for step in (0, 1, 3, 6, 7, 49, 50, 99, 100, 250):
        got = tema.ema_decay_at(step, decay, final, n_steps)
        want = float(jema.ema_decay_at(step, decay, final, n_steps))
        assert isinstance(got, float)
        assert abs(got - want) <= TOL, (step, got, want)


def _tree(seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return {"a": (scale * rng.normal(size=(3, 4, 5))).astype(np.float32),
            "b": (scale * rng.normal(size=(7,))).astype(np.float32)}


@pytest.mark.parametrize("mode", ["ema", "swa"])
def test_ema_update_matches_jax(mode):
    shadow = _tree(0)
    jshadow = {k: jnp.asarray(v) for k, v in shadow.items()}
    tshadow = {k: torch.from_numpy(v.copy()) for k, v in shadow.items()}
    for step in range(12):
        p = _tree(step + 1)
        if mode == "swa":
            decay = tema.swa_decay_at(step, 4)
            n = max(step - 4, 0)
            assert decay == n / (n + 1.0)
        else:
            decay = tema.ema_decay_at(step, 0.9, 0.99, 10)
        jshadow = jema.ema_update(
            jshadow, {k: jnp.asarray(v) for k, v in p.items()}, decay)
        tema.ema_update(tshadow, {k: torch.from_numpy(v)
                                  for k, v in p.items()}, decay)
        for k in p:
            np.testing.assert_allclose(tshadow[k].numpy(),
                                       np.asarray(jshadow[k]), rtol=0,
                                       atol=TOL)


def test_swa_state_matches_jax():
    """Five SGD steps with SWA from step 2: the shadow of the port's
    ``TrainState`` against the JAX ``TrainState``'s."""
    p0 = _tree(10, scale=1.0)
    grads = [_tree(20 + i, scale=1.0) for i in range(5)]
    sched_j = jsched.cosine_annealing_with_warmup(1e-2, 5)
    sched_t = tsched.cosine_annealing_with_warmup(1e-2, 5)
    jstate = JaxTrainState.create(
        None, {k: jnp.asarray(v) for k, v in p0.items()},
        joptim.get_optimizer("sgd", learning_rate=sched_j), with_ema=True,
        ema_mode="swa", swa_start_step=2)
    model = types.SimpleNamespace(named_parameters=lambda: [
        (k, torch.nn.Parameter(torch.from_numpy(v.copy())))
        for k, v in p0.items()])
    tstate = TrainState.create(
        model, lambda p: toptim.get_optimizer("sgd", sched_t, params=p),
        swa_start_step=2)
    for g in grads:
        jstate = jstate.apply_gradients(
            {k: jnp.asarray(v) for k, v in g.items()})
        tstate.apply_gradients({k: torch.from_numpy(v)
                                for k, v in g.items()})
    assert tstate.step == int(jstate.step) == 5
    for k in p0:
        # 1e-6: the optimizer's parity tolerance
        np.testing.assert_allclose(tstate.ema_params[k].numpy(),
                                   np.asarray(jstate.ema_params[k]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tstate.params[k].detach().numpy(),
                                   np.asarray(jstate.params[k]),
                                   rtol=1e-6, atol=1e-6)


# -- early stopping -----------------------------------------------------------

SEQUENCES = [
    ("val_loss", "min", 2, [1.0, 0.9, 0.95, 0.97, 0.8, 0.7]),
    ("val_loss", "min", 3, [1.0, 0.9, 0.95, 0.97, 0.8, 0.81, 0.82, 0.83]),
    ("val_dice", "max", 2, [0.1, 0.3, 0.2, 0.25, 0.4]),
    ("val_dice", "max", 1, [0.1, 0.1, 0.3]),
    ("val_loss", "min", None, [1.0, 1.1, 1.2, 1.3]),
]


def _scripted(values, framework):
    """Train and eval steps that replay ``values`` as the validation
    metric, one per epoch."""
    it = iter(values)

    if framework == "jax":
        def train_step(state, batch, rng):
            return state, {"loss": np.float32(1.0)}

        def eval_step(params, batch, rng):
            v = next(it)
            return {"loss": np.float32(v), "dice": np.float32(v)}
    else:
        def train_step(state, batch):
            return state, {"loss": torch.tensor(1.0)}

        def eval_step(params, batch):
            v = next(it)
            return {"loss": torch.tensor(v), "dice": torch.tensor(v)}
    return train_step, eval_step


@pytest.mark.parametrize("monitor,mode,patience,values", SEQUENCES)
def test_early_stopping_matches_jax(monitor, mode, patience, values):
    loader = [{"image": np.zeros((1, 2), np.float32)}]
    state = types.SimpleNamespace(params={}, ema_params=None)
    jtrain, jeval = _scripted(values, "jax")
    jloop = JaxTrainLoop(jtrain, jeval, max_epochs=len(values),
                         early_stopping=patience, monitor=monitor, mode=mode)
    _, jhist = jloop.fit(state, loader, loader)
    ttrain, teval = _scripted(values, "torch")
    tloop = TrainLoop(ttrain, teval, max_epochs=len(values),
                      early_stopping=patience, monitor=monitor, mode=mode)
    _, thist = tloop.fit(state, loader, loader)
    assert len(thist) == len(jhist)
    np.testing.assert_allclose([h[monitor] for h in thist],
                               [h[monitor] for h in jhist], rtol=1e-6)


def test_callback_stop_ends_training():
    loader = [{"image": np.zeros((1, 2), np.float32)}]
    state = types.SimpleNamespace(params={}, ema_params=None)
    ttrain, teval = _scripted([0.5] * 5, "torch")

    class StopAtTwo:
        def on_epoch_end(self, state, metrics, epoch):
            return "stop" if epoch == 1 else None

    _, hist = TrainLoop(ttrain, teval, max_epochs=5,
                        callbacks=[StopAtTwo()]).fit(state, loader, loader)
    assert len(hist) == 2


# -- NaN guard ----------------------------------------------------------------


def test_nan_guard_raises_and_dumps(tmp_path):
    losses = iter([1.0, 2.0, float("nan"), 3.0])

    def train_step(state, batch):
        return state, {"loss": torch.tensor(next(losses))}

    state = types.SimpleNamespace(
        params={"w": torch.full((3,), -2.0), "b": torch.ones(2)},
        ema_params=None)
    loader = [{"image": np.full((2, 3), i, np.float32)} for i in range(4)]
    loop = TrainLoop(train_step, max_epochs=1,
                     nan_guard=NaNGuard(dump_dir=str(tmp_path)))
    with pytest.raises(FloatingPointError, match="epoch 0 step 3"):
        loop.fit(state, loader)
    dumps = list(tmp_path.glob("nan_dump_e0_s3_*.npz"))
    assert len(dumps) == 1
    with np.load(dumps[0]) as d:
        np.testing.assert_array_equal(d["image"], np.full((2, 3), 2.0))
        np.testing.assert_array_equal(d["param_abs_max"], [2.0, 1.0])
    # the JAX guard reads the same running sum the same way
    jax_state = types.SimpleNamespace(params={"w": np.full((3,), -2.0)})
    with pytest.raises(FloatingPointError):
        JaxNaNGuard(dump_dir=str(tmp_path / "jax")).check(
            {"loss": np.float32("nan")}, jax_state,
            {"image": np.zeros(2)}, 0, 3)
    # a finite sum passes; off by default
    NaNGuard(dump_dir=str(tmp_path)).check(
        {"loss": torch.tensor(4.0)}, state, {}, 0, 1)
    assert TrainLoop(train_step).nan_guard is None


def test_nan_guard_every_n_steps(tmp_path):
    losses = iter([float("nan"), 1.0, 1.0, 1.0])

    def train_step(state, batch):
        return state, {"loss": torch.tensor(next(losses))}

    state = types.SimpleNamespace(params={"w": torch.ones(1)},
                                  ema_params=None)
    loader = [{"image": np.zeros((1, 1), np.float32)}] * 4
    loop = TrainLoop(train_step, max_epochs=1,
                     nan_guard=NaNGuard(str(tmp_path), every=2))
    # the NaN of step 1 stays in the running sum until the check of step 2
    with pytest.raises(FloatingPointError, match="step 2"):
        loop.fit(state, loader)


# -- resume -------------------------------------------------------------------


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(4, 2)

    def forward(self, x):
        return self.lin(x)


def _state(seed, t_max=12):
    torch.manual_seed(seed)
    model = _Tiny()
    schedule = tsched.cosine_annealing_with_warmup(0.1, t_max, 2)
    state = TrainState.create(
        model, lambda p: toptim.get_optimizer("sgd", schedule, params=p),
        swa_start_step=3)
    return model, state


def _train_step(model):
    def step(state, batch):
        out = torch.func.functional_call(model, state.params,
                                         (batch["image"],))
        loss = ((out - 1.0) ** 2).mean()
        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[k] for k in names])
        state.apply_gradients(dict(zip(names, grads)))
        return state, {"loss": loss.detach()}
    return step


def test_resume_restores_state_and_continues(tmp_path):
    rng = np.random.default_rng(0)
    loader = [{"image": rng.normal(size=(2, 4)).astype(np.float32)}
              for _ in range(3)]
    ck = CheckpointManager(str(tmp_path), name="seg", fold=0,
                           monitor="loss", mode="min")
    ck.begin_run()
    assert ck.status(4) == "fresh"
    model, state = _state(0)
    TrainLoop(_train_step(model), max_epochs=2, ckpt_manager=ck).fit(
        state, loader)
    assert ck.status(4) == "resume" and ck.status(2) == "finished"
    saved = {k: v.detach().clone() for k, v in state.params.items()}
    saved_ema = {k: v.clone() for k, v in state.ema_params.items()}
    saved_opt = {k: v["momentum_buffer"].clone()
                 for k, v in state.tx.opt.state.items()}

    # a fresh state from another seed, restored
    model2, state2 = _state(1)
    ck.begin_run(resume=True)
    state2, start = ck.resume(state2)
    assert start == 2 and state2.step == 6 and state2.tx.count == 6
    for k in saved:
        assert torch.equal(state2.params[k].detach(), saved[k])
        assert torch.equal(state2.ema_params[k], saved_ema[k])
    bufs = [s["momentum_buffer"] for s in state2.tx.opt.state.values()]
    assert len(bufs) == len(saved_opt)
    for b, want in zip(bufs, saved_opt.values()):
        assert torch.equal(b, want)
    # the learning rate goes on from step 6 of the schedule
    schedule = tsched.cosine_annealing_with_warmup(0.1, 12, 2)
    assert state2.tx.lr(state2.tx.count) == schedule(6)

    _, hist = TrainLoop(_train_step(model2), max_epochs=4,
                        ckpt_manager=ck).fit(state2, loader,
                                             start_epoch=start)
    assert len(hist) == 2
    assert state2.step == 12 and ck.status(4) == "finished"
    last = torch.load(tmp_path / "seg_fold0" / "last.pt", weights_only=True)
    assert last["epoch"] == 4 and last["schedule_step"] == 12

    # a fresh run drops the last state
    ck.begin_run()
    assert ck.status(4) == "fresh"
    assert ck.resume(state2)[1] == 0
