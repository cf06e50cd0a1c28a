"""
The port's training pieces against the JAX package's, on the CPU.

The same numpy inputs and weights (moved through ``from_flax``) go
through both sides, in f32 (the JAX side runs its matmuls at f32
precision, ``tests/conftest.py``). Tolerances, each stated where it is
used: the step's loss and per-parameter gradients 1e-4 relative (two
frameworks summing the same products in different orders through a whole
U-Net), the optimizers 1e-6 (the same arithmetic on the same gradients),
the losses 1e-5, the schedule 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adell_mri_tpu.config import parsing as jparsing
from adell_mri_tpu.entrypoints.segmentation import train as jtrain
from adell_mri_tpu.models.segmentation import losses as jlosses
from adell_mri_tpu.models.segmentation.unet import UNet as JaxUNet
from adell_mri_tpu.train import optim as joptim
from adell_mri_tpu.train import schedules as jsched
from adell_mri_tpu.train import steps as jsteps
from adell_mri_torch.config import parsing as tparsing
from adell_mri_torch.entrypoints.segmentation import train as ttrain
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.segmentation import losses as tlosses
from adell_mri_torch.models.segmentation.unet import UNet
from adell_mri_torch.train import optim as toptim
from adell_mri_torch.train import schedules as tsched
from adell_mri_torch.train import steps as tsteps
from adell_mri_torch.train.checkpoints import CheckpointManager
from adell_mri_torch.train.precision import cast_floats, wrap_apply
from adell_mri_torch.train.state import TrainState
from test_torch_unet import random_flax_params

SMALL = dict(
    spatial_dimensions=3,
    conv_type="regular",
    link_type="residual",
    upscale_type="transpose",
    norm_type="instance",
    activation_fn="swish",
    dropout_param=0.0,
    n_classes=2,
    depth=(4, 4, 8),
    kernel_sizes=(3, 3, 3),
    strides=(2, 2, 2),
)


def _batch(seed=0, shape=(2, 16, 16, 8)):
    rng = np.random.default_rng(seed)
    image = rng.uniform(size=shape + (1,)).astype(np.float32)
    label = (rng.uniform(size=shape) > 0.6).astype(np.float32)
    return image, label


@pytest.fixture(scope="module")
def step_pair():
    """Loss, metrics and gradients of one segmentation step (dice +
    focal) on both sides, from the same weights and batch."""
    image, label = _batch()
    spec = {"dice": {}, "focal": {"gamma": 2.0}}
    jm = JaxUNet(**SMALL)
    params = random_flax_params(jm, jnp.asarray(image), seed=3)
    jlm = jsteps.make_segmentation_step(
        jm, jparsing.build_compound_loss(spec, 2), train=True
    )
    (jloss, jmet), jgrads = jax.value_and_grad(jlm, has_aux=True)(
        params, {"image": jnp.asarray(image), "label": jnp.asarray(label)},
        jax.random.PRNGKey(0),
    )
    tm = UNet(**SMALL)
    tm.load_state_dict(from_flax(params))
    tlm = tsteps.make_segmentation_step(
        tm, tparsing.build_compound_loss(spec, 2), train=True
    )
    tparams = dict(tm.named_parameters())
    tloss, tmet = tlm(
        tparams,
        {"image": torch.from_numpy(image), "label": torch.from_numpy(label)},
    )
    names = list(tparams)
    tgrads = torch.autograd.grad(tloss, [tparams[k] for k in names])
    return dict(
        jloss=float(jloss), jmet={k: float(v) for k, v in jmet.items()},
        jgrads=from_flax(jgrads), tloss=float(tloss),
        tmet={k: float(v) for k, v in tmet.items()},
        tgrads=dict(zip(names, tgrads)), model=tm, lm=tlm,
        batch=(image, label),
    )


def test_segmentation_step_loss_matches_jax(step_pair):
    # 1e-4 relative: the same f32 U-Net in two frameworks
    assert abs(step_pair["tloss"] - step_pair["jloss"]) <= 1e-4 * abs(
        step_pair["jloss"]
    )
    assert set(step_pair["tmet"]) == set(step_pair["jmet"])
    for k, v in step_pair["jmet"].items():
        assert abs(step_pair["tmet"][k] - v) <= 1e-4 * max(abs(v), 1e-3), k


def test_segmentation_step_gradients_match_jax(step_pair):
    jg, tg = step_pair["jgrads"], step_pair["tgrads"]
    assert set(jg) == set(tg)
    scale = max(float(g.abs().max()) for g in jg.values())
    for k, want in jg.items():
        got = tg[k].detach()
        assert got.shape == want.shape, k
        own = float(want.abs().max())
        if own < 1e-5 * scale:
            # a conv bias ahead of an instance norm: its gradient is zero,
            # rounding noise on both sides
            assert float(got.abs().max()) < 1e-5 * scale, k
            continue
        # 1e-4 of the parameter's own gradient scale
        assert float((got - want).abs().max()) <= 1e-4 * own, k


def test_bf16_step_gives_f32_gradients(step_pair):
    """The mixed-precision policy: bf16 copies in the forward, f32 loss
    and finite f32 gradients on the masters."""
    model, (image, label) = step_pair["model"], step_pair["batch"]
    lm = tsteps.make_segmentation_step(
        model, tparsing.build_compound_loss({"dice": {}}, 2),
        precision="bf16",
    )
    params = dict(model.named_parameters())
    loss, metrics = lm(params, {"image": torch.from_numpy(image),
                                "label": torch.from_numpy(label)})
    assert loss.dtype == torch.float32 and metrics["dice"].dtype == (
        torch.float32
    )
    grads = torch.autograd.grad(loss, list(params.values()))
    assert all(g.dtype == torch.float32 for g in grads)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_wrap_apply_casts_in_and_out():
    seen = {}

    def apply_fn(params, x):
        seen["dtypes"] = (params["w"].dtype, x.dtype)
        return {"y": x * params["w"], "n": torch.tensor(3)}

    params = {"w": torch.ones(2, requires_grad=True)}
    out = wrap_apply(apply_fn, "bf16")(params, torch.ones(2))
    assert seen["dtypes"] == (torch.bfloat16, torch.bfloat16)
    assert out["y"].dtype == torch.float32 and out["n"].dtype == torch.int64
    out["y"].sum().backward()
    assert params["w"].grad.dtype == torch.float32
    assert wrap_apply(apply_fn, "32") is apply_fn
    assert cast_floats([torch.ones(1)], torch.bfloat16)[0].dtype == (
        torch.bfloat16
    )


def test_unported_step_options_raise(step_pair):
    """Deep supervision is ported; asked of a model built without its
    heads, the step refuses at construction."""
    with pytest.raises(ValueError, match="without its head"):
        tsteps.make_segmentation_step(
            step_pair["model"], None, deep_supervision=True
        )


def test_train_step_updates_parameters(step_pair):
    image, label = step_pair["batch"]
    model = UNet(**SMALL)
    model.load_state_dict(step_pair["model"].state_dict())
    state = TrainState.create(
        model, lambda p: toptim.get_optimizer("sgd", 1e-2, params=p)
    )
    before = {k: v.detach().clone() for k, v in state.params.items()}
    lm = tsteps.make_segmentation_step(
        model, tparsing.build_compound_loss({"dice": {}, "focal": {
            "gamma": 2.0}}, 2))
    state, metrics = tsteps.make_train_step(lm)(
        state, {"image": torch.from_numpy(image),
                "label": torch.from_numpy(label)}
    )
    assert state.step == 1 and not metrics["loss"].requires_grad
    # first Nesterov step from zero momentum: p -= lr * (1 + 0.99) * g
    for k, g in step_pair["tgrads"].items():
        want = before[k] - 1e-2 * 1.99 * g
        torch.testing.assert_close(state.params[k].detach(), want,
                                   rtol=1e-5, atol=1e-7)
    evaluated = tsteps.make_eval_step(lm)(
        state.params, {"image": torch.from_numpy(image),
                       "label": torch.from_numpy(label)})
    assert float(evaluated["loss"]) < float(metrics["loss"])


# -- optimizers ---------------------------------------------------------------


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("sgd", {}),
        ("sgd", {"weight_decay": 0.01, "clip_norm": 0.5}),
        ("adam", {"weight_decay": 0.01}),
        ("adamw", {"weight_decay": 0.05}),
        ("adamw", {"clip_norm": 1.0}),
    ],
)
def test_optimizer_two_steps_match_optax(name, kwargs):
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "b": (5,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [
        {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        for _ in range(2)
    ]
    schedule_t = tsched.cosine_annealing_with_warmup(1e-2, 10, 2)
    schedule_j = jsched.cosine_annealing_with_warmup(1e-2, 10, 2)
    tx = joptim.get_optimizer(name, learning_rate=schedule_j, **kwargs)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp
        )
        jp = optax.apply_updates(jp, updates)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = toptim.get_optimizer(name, learning_rate=schedule_t, params=tp,
                               **kwargs)
    for g in grads:
        with torch.no_grad():
            opt.step({k: torch.from_numpy(v) for k, v in g.items()}, tp)
    for k in shapes:
        # 1e-6: the same update rule in f32 on both sides
        np.testing.assert_allclose(
            tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6
        )


def test_unknown_optimizer_raises():
    with pytest.raises(NotImplementedError):
        toptim.get_optimizer("lamb", params={"a": torch.zeros(1)})


# -- schedule ---------------------------------------------------------------


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(base_lr=1e-3, t_max=100),
        dict(base_lr=1e-2, t_max=50, n_warmup_steps=10),
        dict(base_lr=1e-2, t_max=50, n_warmup_steps=0.2, start_decay=0.5),
        dict(base_lr=5e-3, t_max=40, n_warmup_steps=5, eta_min=1e-4,
             start_decay=20),
    ],
)
def test_cosine_schedule_matches_jax(kwargs):
    t = tsched.cosine_annealing_with_warmup(**kwargs)
    j = jsched.cosine_annealing_with_warmup(**kwargs)
    for step in range(0, kwargs["t_max"] + 5):
        # 1e-6 relative: f32 on the JAX side, f64 here
        assert abs(t(step) - float(j(step))) <= 1e-6 * kwargs["base_lr"]


# -- losses -----------------------------------------------------------------


def _loss_inputs(kind, seed=2):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        pred = 1 / (1 + np.exp(-rng.normal(size=(2, 6, 5, 4, 1))))
        target = (rng.uniform(size=(2, 6, 5, 4)) > 0.6).astype(np.float32)
    else:
        logits = rng.normal(size=(2, 6, 5, 4, 3))
        pred = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        target = rng.integers(0, 3, size=(2, 6, 5, 4)).astype(np.float32)
    return pred.astype(np.float32), target


@pytest.mark.parametrize(
    "kind,name",
    [(k, n) for k in ("binary", "categorical")
     for n in tlosses.loss_factory[k]],
)
def test_loss_factory_matches_jax(kind, name):
    assert set(tlosses.loss_factory[kind]) == set(
        jlosses.loss_factory[kind]
    )
    pred, target = _loss_inputs(kind)
    got = float(tlosses.loss_factory[kind][name](
        torch.from_numpy(pred), torch.from_numpy(target)))
    want = float(jlosses.loss_factory[kind][name](
        jnp.asarray(pred), jnp.asarray(target)))
    # 1e-5 relative: f32 sums over a few hundred voxels
    assert abs(got - want) <= 1e-5 * max(abs(want), 1e-3)


@pytest.mark.parametrize("n_classes", [2, 3])
def test_compound_loss_matches_jax(n_classes):
    spec = {"dice": {"smooth": 0.5}, "focal": {}, "tversky_focal": {}}
    overrides = {"gamma": 1.5, "lam": None}
    kind = "binary" if n_classes == 2 else "categorical"
    pred, target = _loss_inputs(kind, seed=4)
    tl = tparsing.build_compound_loss(spec, n_classes, overrides)
    jl = jparsing.build_compound_loss(spec, n_classes, overrides)
    ttot, tind = tl(torch.from_numpy(pred), torch.from_numpy(target))
    jtot, jind = jl(jnp.asarray(pred), jnp.asarray(target))
    assert abs(float(ttot) - float(jtot)) <= 1e-5 * abs(float(jtot))
    for k in jind:
        assert abs(float(tind[k]) - float(jind[k])) <= 1e-5 * max(
            abs(float(jind[k])), 1e-3)


def test_parse_config_unet_matches_jax():
    path = "sample_configs/u-net-3d-resnet.yaml"
    tcfg, tloss = tparsing.parse_config_unet(path, n_keys=2, n_classes=2)
    jcfg, jloss = jparsing.parse_config_unet(path, n_keys=2, n_classes=2)
    assert tcfg == jcfg
    assert list(tloss.losses) == list(jloss.losses)
    for k in tloss.losses:
        assert tloss.losses[k]["params"] == jloss.losses[k]["params"]
    assert tparsing._TRAINING_KEYS == jparsing._TRAINING_KEYS


# -- folds and checkpoints ---------------------------------------------------


@pytest.mark.parametrize("n,n_folds,seed", [(10, 5, 42), (7, 3, 0),
                                             (5, 1, 3), (9, 1, 11)])
def test_folds_match_jax(n, n_folds, seed):
    pids = [f"case_{i}" for i in range(n)]
    assert ttrain.get_folds(pids, n_folds, seed) == jtrain.get_folds(
        pids, n_folds, seed)


def test_checkpoint_keeps_best_monitored_epoch(tmp_path):
    ck = CheckpointManager(str(tmp_path), name="seg", monitor="val_loss",
                           mode="min", metadata={"n_classes": 2})
    w = {"a": torch.zeros(2)}
    ck.save_epoch(1, {"a": torch.full((2,), 1.0)}, {"loss": 0.5})
    assert float(ck.load_state_dict()["a"][0]) == 1.0  # latest, no monitor
    ck.save_epoch(2, {"a": torch.full((2,), 2.0)}, {"val_loss": 0.4})
    ck.save_epoch(3, {"a": torch.full((2,), 3.0)}, {"val_loss": 0.6})
    ck.save_epoch(4, {"a": torch.full((2,), 4.0)}, {"val_loss": float("nan")})
    ck.save_epoch(5, w, {"loss": 0.1})
    assert float(ck.load_state_dict()["a"][0]) == 2.0
    meta = ck.load_metadata()
    assert meta["monitor"] == "val_loss" and meta["mode"] == "min"
    ck.begin_run()
    ck.save_epoch(6, {"a": torch.full((2,), 6.0)}, {"val_loss": 0.9})
    assert float(ck.load_state_dict()["a"][0]) == 6.0
