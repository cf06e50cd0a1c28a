"""
The sample configs' other classifiers against the JAX package's, on the
CPU: VGG, CatNet with ConvNeXt, ConvNeXt-V2 and ResNeXt blocks, the
standalone ConvNeXt (both ``downsample`` modes, at a size the stride does
not divide), the tabular classifier, and the hybrid classifier over VGG
and over CatNet.

Tiny shapes (16x16x8 volumes, widths 4-32), seeded numpy inputs and
parameters (``random_flax_params``'s draw), moved into the port through
``from_flax``. The random draws are injected as in
``tests/test_torch_classification.py``: ensemble members and dropout
masks in call order. Tolerances, each stated where it is used: f32
forwards 1e-5 of the output scale, f32 running statistics 1e-5, the
step's loss 1e-5 relative and each gradient 1e-4 of its own scale from
the JAX step run in f64 (or, for a gradient whose sum cancels below what
f32 resolves, at most twice the JAX f32 step's distance from it; the
port's f64 step within 1e-4 of it too), bf16 probabilities 5e-2 (the
card's bf16 bound).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.config import factories as jfactories
from adell_mri_tpu.models.classification import losses as jlosses
from adell_mri_tpu.models.classification.nets import (
    TabularClassifier as JaxTabular,
)
from adell_mri_tpu.models.layers.res_blocks import (
    ResNeXtBlock as JaxResNeXtBlock,
)
from adell_mri_tpu.train import steps as jsteps
from adell_mri_torch.config import factories as tfactories
from adell_mri_torch.config.parsing import parse_config_cat
from adell_mri_torch.entrypoints.classification.train import (
    parameters_alone,
)
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.classification import losses as tlosses
from adell_mri_torch.models.classification.nets import TabularClassifier
from adell_mri_torch.models.layers import adn as tadn
from adell_mri_torch.models.layers.res_blocks import ResNeXtBlock
from adell_mri_torch.train import steps as tsteps
from test_torch_classification import _Draws, _close, _stats_close, _x

SHAPE = (16, 16, 8)
CONFIGS = Path(__file__).resolve().parents[1] / "sample_configs"
CAT = dict(resnet_structure=[[8, 16, [5, 5, 3], 1], [16, 32, 3, 1]],
           maxpool_structure=[[2, 2, 2], [2, 2, 1]], batch_ensemble=2)
# net id -> (net_type, config, input shape)
NETS = {
    "vgg": ("vgg", dict(first_depth=4, n_blocks=2), SHAPE),
    "cat_convnext": ("convnext", CAT, SHAPE),
    "cat_convnextv2": ("cat", dict(CAT, res_type="convnextv2"), SHAPE),
    "cat_resnext": ("cat", dict(CAT, res_type="resnext"), SHAPE),
    # 17 and 7 are not multiples of the strides: SAME pads the stem
    "convnext_conv": ("convnext_backbone", dict(
        resnet_structure=[[8, 16, 3, 1], [16, 32, [3, 3, 1], 2]],
        first_layer_stride=[2, 2, 1], maxpool_structure=[2, [2, 2, 1]]),
        (17, 14, 7)),
    "convnext_maxpool": ("convnext_v2", dict(
        resnet_structure=[[8, 16, 3, 1], [16, 32, 3, 2]],
        first_layer_stride=2, downsample="maxpool"), (17, 14, 10)),
}
FEATURES = dict(clinical_feature_means=[50.0, 0.5],
                clinical_feature_stds=[10.0, 0.25])


def _params(jm, inputs, seed):
    """``random_flax_params`` for modules of several inputs."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *inputs)
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 0.3 if len(s.shape) == 1 else 1.0 / np.sqrt(
            np.prod(s.shape[:-1]))
        return jnp.asarray((rng.normal(size=s.shape) * scale).astype(
            np.float32))

    return jax.tree.map(draw, shapes["params"])


def _stats(jm, inputs, seed):
    """Running statistics drawn from a seed ({} without batch norms)."""
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *inputs)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: jnp.asarray(rng.uniform(
        0.5, 1.5, s.shape).astype(np.float32)), v.get("batch_stats", {}))


def _tab(b, seed=40):
    rng = np.random.default_rng(seed)
    return np.stack([50 + 10 * rng.normal(size=b),
                     rng.uniform(size=b)], -1).astype(np.float32)


def _build(net, n_classes=2, hybrid=False, b=3, seed=20):
    """The JAX network, its parameters and statistics, the port's with
    them loaded, and the inputs."""
    net_type, cfg, shape = NETS[net]
    feats = FEATURES if hybrid else {}
    jm = jfactories.get_classification_network(net_type, cfg,
                                               n_classes=n_classes, **feats)
    x = np.random.default_rng(seed).uniform(size=(b,) + shape + (1,))
    inputs = (x.astype(np.float32),) + ((_tab(b),) if hybrid else ())
    jin = tuple(jnp.asarray(a) for a in inputs)
    params = _params(jm, jin, seed + 1)
    bs = _stats(jm, jin, seed + 2)
    tm = tfactories.get_classification_network(net_type, cfg,
                                               n_classes=n_classes, **feats)
    tm.load_state_dict(from_flax(params, bs))
    return jm, params, bs, tm, inputs


def _members(net, b):
    if not net.startswith("cat_"):
        return []
    rng = np.random.default_rng(7)
    return [rng.integers(0, 2, b).astype(np.int32) for _ in range(2)]


def _tensors(inputs):
    return tuple(torch.from_numpy(a) for a in inputs)


@pytest.mark.parametrize("n_classes", [2, 3])
@pytest.mark.parametrize("net", list(NETS))
def test_forward_matches_jax(monkeypatch, net, n_classes):
    """Eval logits by the running statistics, the pooled features in
    eval, and a training forward's features and updated statistics (the
    members injected): f32, 1e-5."""
    jm, params, bs, tm, inputs = _build(net, n_classes)
    jin = tuple(jnp.asarray(a) for a in inputs)
    variables = {"params": params, **({"batch_stats": bs} if bs else {})}
    want = np.asarray(jm.apply(variables, *jin))
    assert want.shape == (3, 1 if n_classes == 2 else n_classes)
    want_f = np.asarray(jm.apply(variables, *jin, return_features=True))
    tm.eval()
    with torch.no_grad():
        _close(tm(*_tensors(inputs)), want, 1e-5)
        _close(tm(*_tensors(inputs), return_features=True), want_f, 1e-5)
    _Draws(monkeypatch, members=_members(net, 3))
    jy, upd = jm.apply(variables, *jin, train=True, return_features=True,
                       mutable=["batch_stats"],
                       rngs={"ensemble": jax.random.PRNGKey(1)})
    tm.train()
    with torch.no_grad():
        ty = tm(*_tensors(inputs), return_features=True)
    _close(ty, np.asarray(jy), 1e-5)
    # the head did not run: its statistics come back as they went in
    got = tadn.pop_batch_stats(tm)
    want = from_flax({}, upd.get("batch_stats", {}))
    prior = from_flax({}, bs)
    assert all(torch.equal(want[k], prior[k]) for k in set(want) - set(got))
    _stats_close(got, {k: want[k] for k in got}, 1e-5)


def test_resnext_block_matches_jax():
    """The grouped conv at 16 groups of one and of two channels (inner
    widths 16 and 32) and one whose width rounds down to a multiple of
    its groups (20 -> 16 groups of one), with the projection: training
    output, then eval; f32, 1e-5. The grouped kernel keeps flax's layout
    ``[k, k, k, Cin / g, Cout]``."""
    from test_torch_classification import _adn3, _train_forward_pair

    jadn_fn, tadn_fn = _adn3()
    x = _x((2, 6, 6, 4, 8), seed=30)
    for inter, out_ch, width in ((16, 8, 16), (32, 12, 32), (20, 8, 16)):
        jm = JaxResNeXtBlock(kernel_size=3, inter_channels=inter,
                             out_channels=out_ch, adn_fn=jadn_fn)
        tm = ResNeXtBlock(8, 3, out_ch, tadn_fn, inter_channels=inter)
        assert tuple(tm.Conv_1.weight.shape) == (3, 3, 3, width // 16,
                                                 width)
        r = _train_forward_pair(jm, tm, x)
        _close(r["ty"], r["jy"], 1e-5)
        _stats_close(r["tstats"], r["jstats"], 1e-5)
        _close(r["teval"], r["jeval"], 1e-5)


@pytest.mark.parametrize("inner", ["vgg", "cat_convnext"])
def test_hybrid_matches_jax(inner):
    """``HybridClassifier`` over a headless VGG and CatNet: eval by the
    running statistics and, as the JAX CLI's step and callback apply the
    parameters alone, eval by each batch's statistics
    (``batch_statistics_mode``), f32 within 1e-5; bf16 weights and inputs
    within 5e-2 in probability, the head in f32 on both sides (flax's
    Dense promotes the bf16 features to the f32 standardised ones)."""
    jm, params, bs, tm, inputs = _build(inner, hybrid=True)
    jin = tuple(jnp.asarray(a) for a in inputs)
    assert set(params) == {"convolutional_module", "Dense_0", "Dense_1"}
    tm.eval()
    want = np.asarray(jm.apply({"params": params, "batch_stats": bs}, *jin))
    stateless = np.asarray(jm.apply({"params": params}, *jin, train=False))
    with torch.no_grad():
        _close(tm(*_tensors(inputs)), want, 1e-5)
        with tadn.batch_statistics_mode(tm):
            _close(tm(*_tensors(inputs)), stateless, 1e-5)
    assert not any(k.startswith("convolutional_module.Dense")
                   or "MLP_0" in k for k in tm.state_dict())
    stats = set(tadn.batch_stats(tm))
    bf = {k: v if k in stats else v.to(torch.bfloat16)
          for k, v in tm.state_dict().items()}
    x16 = tuple(t.to(torch.bfloat16) for t in _tensors(inputs))
    with torch.no_grad():
        got16 = torch.func.functional_call(tm, bf, x16)
    assert got16.dtype == torch.float32
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    want16 = jm.apply({"params": jp16, "batch_stats": bs},
                      *(a.astype(jnp.bfloat16) for a in jin))
    assert want16.dtype == jnp.float32
    err = float(np.abs(torch.sigmoid(got16).numpy() - np.asarray(
        jax.nn.sigmoid(want16))).max())
    assert err <= 5e-2, err


@pytest.mark.parametrize("n_classes", [2, 4])
def test_tabular_classifier_matches_jax(n_classes):
    """Standardised by the stored mean and standard deviation, one of
    them 0 (floored at 1e-6), then Dense: f32, 1e-5; and without
    statistics."""
    feats = np.asarray([[1.0, 2.0, 3.0], [0.5, 2.0, -1.0]], np.float32)
    for mean, std in (([0.5, 2.0, 1.0], [0.5, 0.0, 2.0]), (None, None)):
        jm = JaxTabular(n_classes=n_classes, mean=mean, std=std)
        params = _params(jm, (jnp.asarray(feats),), 50)
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(feats)))
        tm = TabularClassifier(3, n_classes, mean, std)
        tm.load_state_dict(from_flax(params))
        with torch.no_grad():
            _close(tm(torch.from_numpy(feats)), want, 1e-5)


STEP_CASES = ["vgg", "cat_convnext", "cat_resnext", "convnext_conv",
              "hybrid_vgg", "hybrid_cat_convnext"]


def _jax_hybrid_step(jm, loss_fn):
    """The JAX classification CLI's step with clinical features
    (``entrypoints/classification/train.py``): the parameters alone, so
    the batch norms normalise by the batch and no statistics move. The
    CLI hands the model a ``dropout`` stream only, and a batch-ensemble
    CatNet there stops at its first step (flax's ``InvalidRngError``:
    no ``ensemble`` stream); this closure adds the stream the plain step
    gives (``train/steps.py``), whose draws the test injects."""

    def lm(params, batch, rng):
        logits = jm.apply({"params": params}, batch["image"],
                          batch["features"], train=True,
                          rngs={"dropout": rng, "ensemble": rng})
        loss = loss_fn(logits, batch["label"])
        return loss, {"loss": loss}

    return lm


def _from_flax64(tree):
    """``from_flax`` of an f64 tree, kept in f64: its layouts are moves
    alone, so the f32 head and the f32 remainder map apart and add up."""
    hi = jax.tree.map(lambda a: a.astype(np.float32), tree)
    lo = jax.tree.map(lambda a, h: (a - h).astype(np.float32), tree, hi)
    lo = from_flax(lo)
    return {k: v.double() + lo[k].double() for k, v in from_flax(hi).items()}


@pytest.mark.parametrize("case", STEP_CASES)
def test_classification_step_matches_jax(monkeypatch, case):
    """One training step's loss (1e-5 relative) and running statistics
    (1e-5) against the JAX step, and every gradient against the JAX step
    run in f64 (``jax.enable_x64``; the batch norms and the tabular
    standardisation stay f32 in both packages): the port's f64 step and
    its f32 step each within 1e-4 of each gradient's own scale (measured:
    1.6e-5 and 8.9e-5 at most). One leaf's sum cancels below what f32
    resolves to 1e-4 (``hybrid_cat_convnext``'s batch-ensemble output
    scale ``s`` ahead of a batch norm, 7e-4 of the step's scale): the
    port's f64 step meets it to 4e-7, while the JAX and port f32 steps
    miss it by 1.2e-3 and 1.4e-3; where the JAX f32 step misses by more
    than 1e-4, the port's f32 step lies at most twice as far. The
    members and dropout masks are injected; binary labels. With clinical
    features (``hybrid_*``: the step given ``feature_key``, in
    ``classification train``'s ``parameters_alone``) the port's step
    moves no statistics and returns none, as the JAX CLI's."""
    hybrid = case.startswith("hybrid_")
    net = case[len("hybrid_"):] if hybrid else case
    b = 4
    jm, params, bs, tm, inputs = _build(net, hybrid=hybrid, b=b, seed=60)
    y = np.asarray([0, 1, 1, 0], np.float32)
    width = 512 if net == "vgg" else 16
    rng = np.random.default_rng(61)
    masks = ([] if hybrid or net.startswith("convnext")
             else [rng.uniform(size=(b, width)) < 0.9 for _ in range(3)])
    batch = {"image": inputs[0], "label": y}
    if hybrid:
        batch["features"] = inputs[1]

    def jax_step(dtype):
        _Draws(monkeypatch, members=_members(net, b), masks=masks)
        cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)
        jbatch = {k: jnp.asarray(v, dtype) for k, v in batch.items()}
        if hybrid:
            jlm = _jax_hybrid_step(jm, jlosses.binary_logistic_loss)
            return jax.value_and_grad(jlm, has_aux=True)(
                cast(params), jbatch, jax.random.PRNGKey(2))
        jlm = jsteps.make_classification_step(jm,
                                              jlosses.binary_logistic_loss)
        return jax.value_and_grad(jlm, has_aux=True)(
            cast(params), jbatch, jax.random.PRNGKey(2),
            variables={"batch_stats": cast(bs)} if bs else None)

    def port_step(dtype):
        _Draws(monkeypatch, members=_members(net, b), masks=masks)
        model = tm.to(dtype)
        tlm = tsteps.make_classification_step(
            model, tlosses.binary_logistic_loss,
            feature_key="features" if hybrid else None)
        if hybrid:
            tlm = parameters_alone(tlm, model, train=True)
        tparams = dict(model.named_parameters())
        tl, tmet = tlm({**tparams, **tadn.batch_stats(model)},
                       {k: torch.from_numpy(v).to(dtype)
                        for k, v in batch.items()})
        grads = torch.autograd.grad(tl, list(tparams.values()))
        return tl, tmet, dict(zip(tparams, grads))

    (jl, jmet), jgrads = jax_step(jnp.float32)
    with jax.enable_x64(True):
        _, jgrads64 = jax_step(jnp.float64)
        ref = _from_flax64(jax.tree.map(np.asarray, jgrads64))
    tl, tmet, tgrads = port_step(torch.float32)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    if hybrid or not bs:
        assert "_variables" not in tmet
    else:
        _stats_close(tmet["_variables"],
                     from_flax({}, jmet["_variables"]["batch_stats"]), 1e-5)
    tgrads64 = port_step(torch.float64)[2]
    want = from_flax(jgrads)
    assert set(tgrads) == set(want) == set(ref)
    scale = max(float(g.abs().max()) for g in ref.values())
    for k, r in ref.items():
        own = float(r.abs().max())
        if own < 1e-5 * scale:
            # a bias ahead of a training batch norm: zero, rounding noise
            assert float(tgrads[k].abs().max()) < 1e-5 * scale, k
            continue
        assert float((tgrads64[k] - r).abs().max()) <= 1e-4 * own, k
        err = float((tgrads[k].double() - r).abs().max())
        jerr = float((want[k].double() - r).abs().max())
        assert err <= max(1e-4 * own, 2 * jerr), (k, err / own,
                                                  jerr / own)


def test_stateless_eval_step_uses_batch_statistics():
    """The hybrid eval step (``feature_key``, in ``classification
    train``'s ``parameters_alone``) normalises by each batch, as the JAX
    CLI's eval closure applies the parameters alone: its loss equals the
    JAX network's applied so (1e-5 relative) and differs from the port's
    forward by the running statistics, which it leaves untouched."""
    jm, params, bs, tm, inputs = _build("vgg", hybrid=True, b=4, seed=70)
    batch = {"image": torch.from_numpy(inputs[0]),
             "features": torch.from_numpy(inputs[1]),
             "label": torch.tensor([0.0, 1.0, 1.0, 0.0])}
    before = {k: v.clone() for k, v in tadn.batch_stats(tm).items()}
    lm = tsteps.make_eval_step(parameters_alone(
        tsteps.make_classification_step(tm, tlosses.binary_logistic_loss,
                                        train=False, feature_key="features"),
        tm, train=False))
    got = float(lm(dict(tm.state_dict()), batch)["loss"])
    want = jm.apply({"params": params}, jnp.asarray(inputs[0]),
                    jnp.asarray(inputs[1]), train=False)
    want = float(jlosses.binary_logistic_loss(want, jnp.asarray(
        batch["label"].numpy())))
    assert abs(got - want) <= 1e-5 * abs(want)
    tm.eval()
    with torch.no_grad():
        running = float(tlosses.binary_logistic_loss(
            tm(batch["image"], batch["features"]), batch["label"]))
    assert abs(running - got) > 1e-3
    for k, v in tadn.batch_stats(tm).items():
        assert torch.equal(v, before[k]), k


YAMLS = {
    "vggnet-net.yaml": ("vgg", (32, 32, 16)),
    "classification-cat-convnext.yaml": ("cat", (32, 32, 16)),
}


@pytest.mark.parametrize("hybrid", [False, True])
@pytest.mark.parametrize("which", list(YAMLS) + ["convnext_backbone",
                                                 "convnext_v2"])
def test_tree_matches_jax(which, hybrid):
    """``from_flax`` on each tree: the sample configs as they stand and
    the standalone ConvNeXt at the factory's defaults, bare and inside
    ``HybridClassifier``: the port's state (parameters and statistics)
    has the JAX tree's names and shapes."""
    if which in YAMLS:
        net_type, shape = YAMLS[which]
        cfg = parse_config_cat(str(CONFIGS / which))["network"]
    else:
        net_type, shape, cfg = which, (32, 32, 16), {}
    feats = FEATURES if hybrid else {}
    jm = jfactories.get_classification_network(net_type, cfg, **feats)
    inputs = (jnp.zeros((1,) + shape + (1,)),) + (
        (jnp.zeros((1, 2)),) if hybrid else ())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *inputs)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = from_flax(zeros["params"], zeros.get("batch_stats"))
    tm = tfactories.get_classification_network(net_type, cfg, **feats)
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
    if which == "classification-cat-convnext.yaml":
        blocks = [n for n, _ in (tm.convolutional_module if hybrid else tm)
                  .ResNetBackbone_0.named_children()]
        assert sum(n.startswith("ConvNeXtBlock_") for n in blocks) == 27
        assert sum(n.startswith("BatchEnsembleConv_") for n in blocks) == 4


# net type -> an option of it the port does not serve yet (None: every
# option the JAX factory reads is ported)
UNPORTED_OPTIONS = {
    "ord": None,
    "vit": {"moe_experts": 2},
    "factorized_vit": None,
    "unet": {"spatial_dimensions": 2},
}


@pytest.mark.parametrize("net_type", list(UNPORTED_OPTIONS))
def test_unported_net_types_raise(net_type):
    """Every net type of the JAX CLI is ported; the options of these four
    that are not (mixture-of-experts blocks, a 2D U-Net encoder) raise,
    and so does a net type the JAX CLI does not have."""
    if UNPORTED_OPTIONS[net_type] is not None:
        with pytest.raises(NotImplementedError, match="not ported"):
            tfactories.get_classification_network(
                net_type, UNPORTED_OPTIONS[net_type], image_size=(16, 16, 8))
    with pytest.raises(NotImplementedError, match="not ported"):
        tfactories.get_classification_network(f"{net_type}_x", {})
