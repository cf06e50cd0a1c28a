"""
The port's classifier (CatNet with a ResNet backbone, batch norm and batch
ensembles) against the JAX package's, on the CPU.

The same numpy inputs and weights (moved through ``from_flax``) go through
both sides. The random draws are injected: the JAX side's
``jax.random.randint`` (the ensemble members) and ``jax.random.bernoulli``
(the head's dropout masks) are patched inside a test, the port's
``BatchEnsembleConv.draw_members`` and ``torch.rand`` (its dropout) return
the same draws. Tolerances, each stated where it is used: f32 forwards
1e-5 of the output scale, f32 running statistics 1e-5, the step's loss
1e-5 relative and its gradients 2e-4 of each parameter's own gradient
scale (two frameworks summing the same products in other orders: at the
stem's batch-norm bias, a sum over every voxel, the JAX gradient lies
7.6e-5 and the port's 3.0e-5 of that scale from an f64 reference), bf16
forwards four bf16 steps (4 * 2^-8) of the output scale (XLA fuses the
norm's four bf16 operations and rounds once, PyTorch rounds after each),
bf16 statistics 1e-2 relative (the batch mean is rounded to bf16 before
it enters them),
the batch preprocessing 1e-6, the losses 1e-6.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.config import factories as jfactories
from adell_mri_tpu.data import samplers as jsamplers
from adell_mri_tpu.models.classification import losses as jlosses
from adell_mri_tpu.models.layers import adn as jadn
from adell_mri_tpu.models.layers.batch_ensemble import (
    BatchEnsembleConv as JaxBatchEnsembleConv,
)
from adell_mri_tpu.models.layers.res_blocks import (
    ResidualBlock as JaxResidualBlock,
)
from adell_mri_tpu.models.layers.res_net import (
    ResNetBackbone as JaxResNetBackbone,
)
from adell_mri_tpu.train import batch_preprocessing as jbp
from adell_mri_tpu.train import steps as jsteps
from adell_mri_tpu.transforms.labels import label_operator as jlabel_operator
from adell_mri_torch.config import factories as tfactories
from adell_mri_torch.config.parsing import parse_config_cat
from adell_mri_torch.data import samplers as tsamplers
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.classification import losses as tlosses
from adell_mri_torch.models.layers import adn as tadn
from adell_mri_torch.models.layers.batch_ensemble import BatchEnsembleConv
from adell_mri_torch.models.layers.blocks import (
    MLP,
    GlobalPooling,
    max_pool,
)
from adell_mri_torch.models.layers.res_blocks import ResidualBlock
from adell_mri_torch.models.layers.res_net import ResNetBackbone
from adell_mri_torch.train import batch_preprocessing as tbp
from adell_mri_torch.train import steps as tsteps
from adell_mri_torch.train.checkpoints import correct_classification_bias
from adell_mri_torch.train.state import TrainState
from adell_mri_torch.train.optim import get_optimizer
from adell_mri_torch.transforms.labels import label_operator
from test_torch_unet import random_flax_params

TINY = dict(resnet_structure=[[8, 16, 3, 1], [16, 32, 3, 1]],
            maxpool_structure=[[2, 2, 2], [2, 2, 1]], batch_ensemble=2,
            res_type="resnet")
SHAPE = (16, 16, 8)
YAML = (Path(__file__).resolve().parents[1] / "sample_configs"
        / "classification-cat-resnet.yaml")
BF16_STEP = 2.0 ** -8


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).detach().float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


def _stats_close(got, want, rel):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().float().numpy()
        w = w.numpy()
        assert np.abs(g - w).max() <= rel * max(np.abs(w).max(), 1e-3), k


class _Draws:
    """Injected draws: ensemble members and dropout masks, handed to the
    JAX side through patched ``jax.random`` and to the port through its
    draw points, in call order."""

    def __init__(self, monkeypatch, members=(), masks=(), keep=0.9):
        self.members, self.masks = list(members), list(masks)
        jm, jk = list(self.members), list(self.masks)
        tm, tk = list(self.members), list(self.masks)
        monkeypatch.setattr(jax.random, "randint",
                            lambda key, shape, lo, hi: jnp.asarray(jm.pop(0)))
        monkeypatch.setattr(
            jax.random, "bernoulli",
            lambda key, p=0.5, shape=None: jnp.asarray(jk.pop(0)))
        monkeypatch.setattr(
            BatchEnsembleConv, "draw_members",
            lambda self, b, device: torch.from_numpy(tm.pop(0)))
        rand = torch.rand

        def fake_rand(*shape, **kw):
            if not tk:
                return rand(*shape, **kw)
            mask = tk.pop(0)
            # below keep where the mask keeps the element
            return torch.from_numpy(np.where(mask, 0.0, 1.0).astype(
                np.float32))

        monkeypatch.setattr(torch, "rand", fake_rand)


# -- batch norm ----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 4, 4, 3, 5), (6, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_batch_norm_matches_jax(shape, dtype):
    """Training output and updated statistics, then eval by the running
    statistics, against ``GlobalBatchNorm``; 5-d volumes and the head's
    1-d [B, F]."""
    feat = shape[-1]
    rng = np.random.default_rng(3)
    x = (2.0 + 3.0 * rng.normal(size=shape)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, feat).astype(np.float32)
    bias = rng.normal(size=feat).astype(np.float32)
    stats = {"mean": rng.normal(size=feat).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, feat).astype(np.float32)}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jm = jadn.GlobalBatchNorm()
    variables = {"params": {"scale": jnp.asarray(scale, jdt),
                            "bias": jnp.asarray(bias, jdt)},
                 "batch_stats": {k: jnp.asarray(v) for k, v in
                                 stats.items()}}
    jy, upd = jm.apply(variables, jnp.asarray(x, jdt),
                       use_running_average=False, mutable=["batch_stats"])
    jeval = jm.apply(variables, jnp.asarray(x, jdt), use_running_average=True)

    tm = tadn.GlobalBatchNorm(feat)
    tm.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        **{k: torch.from_numpy(v) for k, v in stats.items()}})
    tm = tm.to(tdt)
    tm.mean, tm.var = tm.mean.float(), tm.var.float()
    ty = tm.train()(torch.from_numpy(x).to(tdt))
    assert ty.dtype == tdt
    new = dict(zip(("mean", "var"), tm.new_stats))
    teval = tm.eval()(torch.from_numpy(x).to(tdt))
    assert teval.dtype == tdt
    bf16 = dtype == "bfloat16"
    tol = 4 * BF16_STEP if bf16 else 1e-5
    _close(ty, np.asarray(jy.astype(jnp.float32)), tol)
    _close(teval, np.asarray(jeval.astype(jnp.float32)), tol)
    _stats_close({k: v for k, v in new.items()},
                 {k: torch.from_numpy(np.asarray(upd["batch_stats"][k]))
                  for k in ("mean", "var")}, 1e-2 if bf16 else 1e-5)
    assert all(v.dtype == torch.float32 for v in new.values())


def test_fresh_statistics_are_the_one_element_fallback():
    """At eval with one element per feature and no statistics, the JAX
    module normalizes by (0, 1); the port's fresh statistics are (0, 1)."""
    x = _x((1, 5), seed=4)
    jm = jadn.GlobalBatchNorm()
    params = {"scale": jnp.full((5,), 1.5), "bias": jnp.full((5,), 0.25)}
    want = jm.apply({"params": params}, jnp.asarray(x),
                    use_running_average=True)
    tm = tadn.GlobalBatchNorm(5)
    tm.load_state_dict({"weight": torch.full((5,), 1.5),
                        "bias": torch.full((5,), 0.25),
                        "mean": tm.mean, "var": tm.var}, strict=True)
    _close(tm.eval()(torch.from_numpy(x)), np.asarray(want), 1e-6)


def test_batch_adn_needs_features_and_segmentation_nets_refuse_it():
    """A batch ADN needs its width, an unknown norm raises; a batch-norm
    U-Net's training step carries its statistics out
    (``metrics["_variables"]``, tests/test_torch_unet_step.py holds them
    against the JAX step), while UNETR and SWIN-UNet still refuse batch
    norm."""
    with pytest.raises(ValueError, match="feature count"):
        tadn.ActDropNorm(None, norm_fn="batch")
    with pytest.raises(NotImplementedError):
        tadn.ActDropNorm(4, norm_fn="weight_standardised")
    adn = tadn.get_adn_fn("batch", "gelu", 0.1)(6)
    assert set(adn.state_dict()) == {
        "GlobalBatchNorm_0.weight", "GlobalBatchNorm_0.bias",
        "GlobalBatchNorm_0.mean", "GlobalBatchNorm_0.var"}
    from adell_mri_torch.config.parsing import build_compound_loss
    from adell_mri_torch.train.steps import make_segmentation_step

    net = tfactories.get_segmentation_network(
        "unet", {"norm_type": "batch", "depth": [4, 8]})
    x = torch.from_numpy(_x((2, 8, 8, 4, 1), seed=30))
    lm = make_segmentation_step(net, build_compound_loss({"dice": {}}, 2))
    _, metrics = lm(dict(net.state_dict()), {
        "image": x, "label": (x[..., 0] > 0).float()})
    assert set(metrics["_variables"]) == set(tadn.batch_stats(net))
    with pytest.raises(NotImplementedError, match="norm_type"):
        tfactories.get_segmentation_network("swin", {"norm_type": "batch"})


# -- blocks ----------------------------------------------------------------------


def test_pooling_and_mlp_match_jax():
    """Global max and mean pooling, VALID max-pool with a ragged edge,
    and the plain MLP with a batch ADN, against the JAX blocks (1e-6)."""
    from adell_mri_tpu.models.layers import blocks as jblocks

    x = _x((2, 5, 4, 3, 6), seed=5)
    for mode in ("max", "mean"):
        want = jblocks.GlobalPooling(mode=mode).apply({}, jnp.asarray(x))
        _close(GlobalPooling(mode)(torch.from_numpy(x)), np.asarray(want),
               1e-6)
    for window in (2, (2, 2, 1)):
        want = jblocks.max_pool(jnp.asarray(x), window)
        _close(max_pool(torch.from_numpy(x), window), np.asarray(want), 0)
    jm = jblocks.MLP(hidden_dims=(7, 5), out_dim=3,
                     adn_fn=jadn.get_adn_fn(1, "batch", "gelu"))
    feats = _x((4, 6), seed=6)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(feats))
    want = jm.apply(v, jnp.asarray(feats))
    tm = MLP(6, (7, 5), 3, adn_fn=tadn.get_adn_fn("batch", "gelu"))
    tm.load_state_dict(from_flax(v["params"], v["batch_stats"]))
    _close(tm.eval()(torch.from_numpy(feats)), np.asarray(want), 1e-5)


def _adn3():
    return (jadn.get_adn_fn(3, "batch", "swish"),
            tadn.get_adn_fn("batch", "swish"))


def _train_forward_pair(jm, tm, x, jkw=None, tkw=None, stats_seed=9):
    """The JAX module initialised, its statistics randomised, loaded into
    the port; returns both training outputs, both statistics and both
    eval outputs."""
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = random_flax_params(jm, jnp.asarray(x), seed=7)
    rng = np.random.default_rng(stats_seed)
    bs = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape).astype(
            np.float32)) if a.shape else a, v["batch_stats"])
    jy, upd = jm.apply({"params": params, "batch_stats": bs},
                       jnp.asarray(x), train=True, mutable=["batch_stats"],
                       rngs={"ensemble": jax.random.PRNGKey(1)},
                       **(jkw or {}))
    jeval = jm.apply({"params": params, "batch_stats": bs}, jnp.asarray(x),
                     **(jkw or {}))
    tm.load_state_dict(from_flax(params, bs))
    ty = tm.train()(torch.from_numpy(x), **(tkw or {}))
    tstats = tadn.pop_batch_stats(tm)
    teval = tm.eval()(torch.from_numpy(x), **(tkw or {}))
    return dict(jy=np.asarray(jy), ty=ty, jstats=from_flax(
        {}, upd["batch_stats"]), tstats=tstats, jeval=np.asarray(jeval),
        teval=teval)


@pytest.mark.parametrize("out_ch", [4, 6])
def test_bottleneck_residual_block_matches_jax(out_ch):
    """1x1 -> ADN -> 3^3 -> ADN -> 1x1 back, the skip, the projection when
    the width changes (6), the trailing ADN: training output and
    statistics, then eval (f32, 1e-5)."""
    jadn_fn, tadn_fn = _adn3()
    x = _x((2, 6, 6, 4, 4), seed=8)
    jm = JaxResidualBlock(kernel_size=3, inter_channels=8,
                          out_channels=out_ch, adn_fn=jadn_fn)
    tm = ResidualBlock(4, 3, out_ch, tadn_fn, inter_channels=8)
    r = _train_forward_pair(jm, tm, x)
    _close(r["ty"], r["jy"], 1e-5)
    _stats_close(r["tstats"], r["jstats"], 1e-5)
    _close(r["teval"], r["jeval"], 1e-5)
    assert ("Conv_3.weight" in tm.state_dict()) == (out_ch != 4)


@pytest.mark.parametrize("mode", ["train", "eval", "member"])
def test_batch_ensemble_conv_matches_jax(monkeypatch, mode):
    """Training with the members injected, the eval mean over the
    members, and one member (``idx``); f32, 1e-5."""
    members = np.asarray([1, 0, 1], np.int32)
    _Draws(monkeypatch, members=[members])
    jadn_fn, tadn_fn = _adn3()
    x = _x((3, 4, 4, 2, 6), seed=10)
    jm = JaxBatchEnsembleConv(n_ensemble=2, out_channels=5, kernel_size=1,
                              adn_fn=jadn_fn)
    tm = BatchEnsembleConv(6, 2, 5, tadn_fn)
    kw = {"idx": 1} if mode == "member" else {}
    r = _train_forward_pair(jm, tm, x, jkw=kw, tkw=kw)
    if mode == "train":
        _close(r["ty"], r["jy"], 1e-5)
        _stats_close(r["tstats"], r["jstats"], 1e-5)
    else:
        _close(r["teval"], r["jeval"], 1e-5)


def test_resnet_backbone_matches_jax(monkeypatch):
    """The tiny backbone (two stages of two bottleneck blocks and a batch
    ensemble each): training with injected members and eval; f32, 1e-5;
    a maxpool_structure of the wrong length raises on both sides."""
    _Draws(monkeypatch, members=[np.asarray([0, 1], np.int32),
                                 np.asarray([1, 1], np.int32)])
    jadn_fn, tadn_fn = _adn3()
    structure = [tuple(s) for s in TINY["resnet_structure"]]
    pools = [tuple(p) for p in TINY["maxpool_structure"]]
    x = _x((2,) + SHAPE + (1,), seed=11)
    jm = JaxResNetBackbone(structure=structure, maxpool_structure=pools,
                           adn_fn=jadn_fn, batch_ensemble=2)
    tm = ResNetBackbone(1, structure, pools, tadn_fn, batch_ensemble=2)
    r = _train_forward_pair(jm, tm, x)
    _close(r["ty"], r["jy"], 1e-5)
    _stats_close(r["tstats"], r["jstats"], 1e-5)
    _close(r["teval"], r["jeval"], 1e-5)
    with pytest.raises(ValueError, match="maxpool_structure"):
        ResNetBackbone(1, structure, pools[:1], tadn_fn)
    with pytest.raises(ValueError, match="maxpool_structure"):
        JaxResNetBackbone(structure=structure, maxpool_structure=pools[:1],
                          adn_fn=jadn_fn).init(jax.random.PRNGKey(0),
                                               jnp.asarray(x))


# -- CatNet ----------------------------------------------------------------------


def _trained_stats(jm, params, x, steps=6):
    """Running statistics of a few JAX training forwards on ``x``: a
    realistic scale for the eval path."""
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    bs = v["batch_stats"]

    @jax.jit
    def fwd(bs, key):
        _, upd = jm.apply({"params": params, "batch_stats": bs},
                          jnp.asarray(x), train=True,
                          mutable=["batch_stats"],
                          rngs={"dropout": key, "ensemble": key})
        return upd["batch_stats"]

    for i in range(steps):
        bs = fwd(bs, jax.random.PRNGKey(i))
    return bs


@pytest.fixture(scope="module")
def catnet():
    x = np.random.default_rng(12).uniform(size=(4,) + SHAPE + (1,))
    x = x.astype(np.float32)
    out = {"x": x}
    for n_classes in (2, 3):
        jm = jfactories.get_classification_network("cat", TINY,
                                                   n_classes=n_classes)
        params = jax.tree.map(
            jnp.asarray, random_flax_params(jm, jnp.asarray(x), seed=13))
        bs = _trained_stats(jm, params, x)
        tm = tfactories.get_classification_network("cat", TINY,
                                                   n_classes=n_classes)
        tm.load_state_dict(from_flax(params, bs))
        out[n_classes] = dict(jm=jm, params=params, bs=bs, tm=tm)
    return out


@pytest.mark.parametrize("n_classes", [2, 3])
def test_catnet_logits_match_jax(catnet, n_classes):
    """Eval logits with trained running statistics: f32 within 1e-5 of the
    scale; bf16 (weights and input cast, statistics f32) within 5e-2 in
    probability, the tolerance of the card's bf16 checks: the JAX module
    leaves bf16 after its first batch norm (f32 statistics promote), the
    port stays in the compute dtype."""
    c, x = catnet[n_classes], catnet["x"]
    variables = {"params": c["params"], "batch_stats": c["bs"]}
    want = np.asarray(c["jm"].apply(variables, jnp.asarray(x)))
    assert want.shape == (4, 1 if n_classes == 2 else 3)
    tm = c["tm"].eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, want, 1e-5)
    stats = set(tadn.batch_stats(tm))
    bf = {k: v if k in stats else v.to(torch.bfloat16)
          for k, v in tm.state_dict().items()}
    with torch.no_grad():
        got16 = torch.func.functional_call(
            tm, bf, (torch.from_numpy(x).to(torch.bfloat16),)).float()
    act = (lambda z: torch.softmax(z, -1)) if n_classes > 2 else torch.sigmoid
    err = float((act(got16) - act(torch.from_numpy(want))).abs().max())
    assert err <= 5e-2, err


def test_catnet_features_and_unported_options():
    jm = jfactories.get_classification_network("cat", TINY)
    x = _x((2,) + SHAPE + (1,), seed=14)
    params = random_flax_params(jm, jnp.asarray(x), seed=15)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jm.apply({"params": params, "batch_stats": v["batch_stats"]},
                    jnp.asarray(x), return_features=True)
    tm = tfactories.get_classification_network("resnet", TINY)
    tm.load_state_dict(from_flax(params, v["batch_stats"]))
    with torch.no_grad():
        _close(tm.eval()(torch.from_numpy(x), return_features=True),
               np.asarray(want), 1e-5)
    # spatial_dimensions 2 builds networks of the input's rank, 3D for
    # volumes, as the JAX modules are (their convs take the input's rank)
    for net_type, cfg, conv in (
            ("vgg", {}, "VGGConvolution_0.Conv_0.weight"),
            ("cat", TINY, "ResNetBackbone_0.Conv_0.weight")):
        net = tfactories.get_classification_network(
            net_type, {**cfg, "spatial_dimensions": 2})
        assert net.state_dict()[conv].dim() == 5
    with pytest.raises(NotImplementedError, match="not ported"):
        tfactories.get_classification_network(
            "vit", {"moe_experts": 2}, image_size=SHAPE)
    # res_type resnext and feature_extraction (a headless CatNet, the
    # network a HybridClassifier wraps) are ported: eval features and
    # logits against the JAX network's (f32, 1e-5)
    from adell_mri_tpu.models.classification.nets import CatNet as JaxCatNet
    from adell_mri_torch.models.classification import CatNet

    resnext = {**TINY, "res_type": "resnext"}
    jm = jfactories.get_classification_network("cat", resnext)
    params = random_flax_params(jm, jnp.asarray(x), seed=16)
    bs = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["batch_stats"]
    tm = tfactories.get_classification_network("cat", resnext)
    tm.load_state_dict(from_flax(params, bs))
    with torch.no_grad():
        _close(tm.eval()(torch.from_numpy(x)), np.asarray(jm.apply(
            {"params": params, "batch_stats": bs}, jnp.asarray(x))), 1e-5)
    structure = [tuple(s) for s in TINY["resnet_structure"]]
    jm = JaxCatNet(resnet_structure=structure, feature_extraction=True)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = CatNet(resnet_structure=structure, feature_extraction=True)
    tm.load_state_dict(from_flax(v["params"], v["batch_stats"]))
    assert not any(k.startswith("Dense_") for k in tm.state_dict())
    with torch.no_grad():
        _close(tm.eval()(torch.from_numpy(x)),
               np.asarray(jm.apply(v, jnp.asarray(x))), 1e-5)


def test_yaml_tree_matches_jax():
    """``sample_configs/classification-cat-resnet.yaml`` as it stands: the
    port's state (parameters and statistics) has the JAX tree's names and
    shapes, through ``from_flax``'s mapping."""
    cfg = parse_config_cat(str(YAML))
    net = cfg["network"]
    jm = jfactories.get_classification_network("cat", net)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 16, 1)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = from_flax(zeros["params"], zeros["batch_stats"])
    tm = tfactories.get_classification_network("cat", net)
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
    assert cfg["training"]["batch_size"] == 16
    # the yaml's stages: 2, 3, 2, 2 blocks, a batch ensemble after each
    names = [n for n, _ in tm.named_children()]
    assert names[0] == "ResNetBackbone_0"
    backbone = tm.ResNetBackbone_0
    assert sum(n.startswith("ResidualBlock_")
               for n, _ in backbone.named_children()) == 9
    assert sum(n.startswith("BatchEnsembleConv_")
               for n, _ in backbone.named_children()) == 4


# -- the train step --------------------------------------------------------------


def _step_draws(batch):
    rng = np.random.default_rng(16)
    members = [rng.integers(0, 2, batch).astype(np.int32) for _ in range(2)]
    masks = [rng.uniform(size=(batch, 16)) < 0.9 for _ in range(3)]
    return members, masks


@pytest.mark.parametrize("case", ["binary", "multiclass", "smoothing"])
def test_classification_step_matches_jax(monkeypatch, catnet, case):
    """``make_classification_step`` in training: loss and accuracy (1e-5
    relative), every gradient (2e-4 of its own scale) and the updated
    running statistics (1e-5), the members and dropout masks injected;
    binary, multiclass with weights, and binary with label smoothing."""
    n_classes = 3 if case == "multiclass" else 2
    c, x = catnet[n_classes], catnet["x"]
    members, masks = _step_draws(x.shape[0])
    _Draws(monkeypatch, members=members, masks=masks)
    if n_classes == 2:
        y = np.asarray([0, 1, 1, 0], np.float32)
        jloss = lambda z, t: jlosses.binary_logistic_loss(z, t, weight=2.0)
        tloss = lambda z, t: tlosses.binary_logistic_loss(z, t, weight=2.0)
    else:
        y = np.asarray([0, 2, 1, 2], np.float32)
        w = np.asarray([1.0, 0.5, 2.0], np.float32)
        jloss = lambda z, t: jlosses.cross_entropy_loss(z, t, weight=w)
        tloss = lambda z, t: tlosses.cross_entropy_loss(z, t, weight=w)
    jprep = tprep = None
    if case == "smoothing":
        jprep = jbp.BatchPreprocessing(label_smoothing_param=0.1)
        tprep = tbp.BatchPreprocessing(label_smoothing_param=0.1)
    jlm = jsteps.make_classification_step(
        c["jm"], jloss, n_classes=n_classes, batch_preprocessing=jprep)
    (jl, jmet), jgrads = jax.value_and_grad(jlm, has_aux=True)(
        c["params"], {"image": jnp.asarray(x), "label": jnp.asarray(y)},
        jax.random.PRNGKey(2), variables={"batch_stats": c["bs"]})
    tm = c["tm"]
    tlm = tsteps.make_classification_step(tm, tloss, n_classes=n_classes,
                                          batch_preprocessing=tprep)
    params = dict(tm.named_parameters())
    weights = {**params, **tadn.batch_stats(tm)}
    tl, tmet = tlm(weights, {"image": torch.from_numpy(x),
                             "label": torch.from_numpy(y)})
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert abs(float(tmet["acc"]) - float(jmet["acc"])) <= 1e-6
    _stats_close(tmet["_variables"],
                 from_flax({}, jmet["_variables"]["batch_stats"]), 1e-5)
    names = list(params)
    tgrads = dict(zip(names, torch.autograd.grad(
        tl, [params[k] for k in names])))
    want = from_flax(jgrads)
    assert set(tgrads) == set(want)
    scale = max(float(g.abs().max()) for g in want.values())
    for k, g in want.items():
        own = float(g.abs().max())
        if own < 1e-5 * scale:
            # a bias ahead of a training batch norm: its gradient is zero,
            # rounding noise on both sides
            assert float(tgrads[k].abs().max()) < 1e-5 * scale, k
            continue
        assert float((tgrads[k] - g).abs().max()) <= 2e-4 * own, k


def test_train_step_carries_statistics_and_eval_uses_them(catnet):
    """A training step moves the state's statistics (f32, new tensors, the
    parameters averaged by SWA alone) and an eval step normalizes by
    them: its loss equals the model's eval forward with them loaded."""
    c, x = catnet[2], catnet["x"]
    tm = tfactories.get_classification_network("cat", TINY)
    tm.load_state_dict(c["tm"].state_dict())
    y = torch.tensor([0.0, 1.0, 1.0, 0.0])
    state = TrainState.create(
        tm, lambda p: get_optimizer("sgd", 1e-2, params=p), swa_start_step=0)
    before = {k: v.clone() for k, v in state.variables.items()}
    assert set(before) == set(tadn.batch_stats(tm)) and before
    lm = tsteps.make_classification_step(tm, tlosses.binary_logistic_loss)
    batch = {"image": torch.from_numpy(x), "label": y}
    state, metrics = tsteps.make_train_step(lm)(state, batch)
    assert "_variables" not in metrics and set(metrics) == {"loss", "acc"}
    assert all(not torch.equal(state.variables[k], v)
               for k, v in before.items() if k.endswith(".mean"))
    assert all(v.dtype == torch.float32 for v in state.variables.values())
    assert set(state.state_dict()) == set(tm.state_dict())
    evaluate = tsteps.make_eval_step(tsteps.make_classification_step(
        tm, tlosses.binary_logistic_loss, train=False))
    got = evaluate(state.weights(state.ema_params), batch)
    ref = tfactories.get_classification_network("cat", TINY)
    ref.load_state_dict({**state.state_dict(), **{
        k: v for k, v in state.ema_params.items()}})
    with torch.no_grad():
        want = tlosses.binary_logistic_loss(ref.eval()(batch["image"]), y)
    assert abs(float(got["loss"]) - float(want)) <= 1e-6


def test_bf16_step_keeps_statistics_f32(catnet):
    c, x = catnet[3], catnet["x"]
    tm = c["tm"]
    lm = tsteps.make_classification_step(
        tm, tlosses.cross_entropy_loss, n_classes=3, precision="bf16")
    params = dict(tm.named_parameters())
    loss, metrics = lm({**params, **tadn.batch_stats(tm)},
                       {"image": torch.from_numpy(x),
                        "label": torch.tensor([0.0, 1.0, 2.0, 1.0])})
    assert loss.dtype == torch.float32
    assert all(v.dtype == torch.float32
               for v in metrics["_variables"].values())
    grads = torch.autograd.grad(loss, list(params.values()))
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in grads)


# -- batch preprocessing, losses, samplers, labels -------------------------------


class _FakeRng:
    def __init__(self, lam, perm, sel):
        self.lam, self.perm, self.sel = lam, perm, sel

    def beta(self, a, b):
        return self.lam

    def permutation(self, n):
        return self.perm

    def random(self, n):
        return np.where(self.sel, 0.0, 1.0)


@pytest.mark.parametrize("n_classes", [2, 4])
@pytest.mark.parametrize("partial", [None, 0.5])
@pytest.mark.parametrize("smoothing", [None, 0.1])
def test_batch_preprocessing_matches_jax(n_classes, partial, smoothing):
    """Mixup (whole or partial) then label smoothing, the JAX draws of one
    key handed to the port's generator: 1e-6."""
    key = jax.random.PRNGKey(5)
    x = _x((6, 4, 4, 2, 1), seed=17)
    y = np.asarray([0, 1, 1, 0, 1, 0] if n_classes == 2
                   else [0, 3, 1, 2, 2, 1], np.float32)
    jpre = jbp.BatchPreprocessing(smoothing, 0.4, partial,
                                  n_classes=n_classes)
    jx, jy = jpre(key, jnp.asarray(x), jnp.asarray(y))
    lam = np.float32(jax.random.beta(key, 0.4, 0.4))
    perm = np.asarray(jax.random.permutation(jax.random.fold_in(key, 1), 6))
    sel = np.asarray(jax.random.bernoulli(jax.random.fold_in(key, 2),
                                          partial or 0.5, (6,)))
    tpre = tbp.BatchPreprocessing(smoothing, 0.4, partial,
                                  n_classes=n_classes)
    tpre.rng = _FakeRng(lam, perm, sel)
    tx, ty = tpre(torch.from_numpy(x), torch.from_numpy(y))
    _close(tx, np.asarray(jx), 1e-6)
    _close(ty, np.asarray(jy), 1e-6)
    assert ty.dtype == torch.float32


def test_losses_match_jax():
    rng = np.random.default_rng(18)
    z1 = rng.normal(size=(5, 1)).astype(np.float32)
    y1 = np.asarray([0, 1, 0.9, 0.1, 1], np.float32)
    for w in (None, 3.0):
        _close(tlosses.binary_logistic_loss(torch.from_numpy(z1),
                                            torch.from_numpy(y1), w),
               np.asarray(jlosses.binary_logistic_loss(
                   jnp.asarray(z1), jnp.asarray(y1), w)), 1e-6)
    z = rng.normal(size=(5, 3)).astype(np.float32)
    hard = np.asarray([0, 2, 1, 1, 0], np.float32)
    soft = rng.dirichlet(np.ones(3), 5).astype(np.float32)
    for y in (hard, soft):
        for w in (None, np.asarray([1.0, 2.0, 0.5], np.float32)):
            for s in (0.0, 0.1):
                _close(tlosses.cross_entropy_loss(
                    torch.from_numpy(z), torch.from_numpy(y), w, s),
                    np.asarray(jlosses.cross_entropy_loss(
                        jnp.asarray(z), jnp.asarray(y), w, s)), 1e-6)


@pytest.mark.parametrize("shape", [(16, 16, 8), (128, 128, 32)])
def test_classification_policy_matches_jax_cli(shape):
    """``AugmentPolicy.classification`` holds the values the JAX
    ``classification train`` passes to its policy, field by field."""
    from adell_mri_torch.transforms.pipeline import AugmentPolicy
    from adell_mri_tpu.transforms.pipeline import AugmentPolicy as JPolicy

    flags = ("intensity", "noise", "affine", "flip")
    want = JPolicy.from_flags(
        flags, prob=0.1, flip_axes=(0, 1),
        rotate_range=(np.pi / 16, 0.0, 0.0), scale_range=(0.1, 0.1, 0.05),
        translate_range=tuple(v / s for v, s in zip((4.0, 4.0, 1.0),
                                                     shape)))
    got = AugmentPolicy.classification(flags, shape)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_samplers_and_labels_match_jax():
    labels = ["a", "b", "b", "c", "b", "a", "b"]
    np.testing.assert_allclose(
        tsamplers.class_weights_from_labels(labels),
        jsamplers.class_weights_from_labels(labels))
    w = tsamplers.class_weights_from_labels(labels)
    got = list(tsamplers.WeightedSampler(w, n_samples=20, seed=3))
    want = list(jsamplers.WeightedSampler(w, n_samples=20, seed=3))
    assert got == want and len(tsamplers.WeightedSampler(w)) == 7
    for value, kw in (("b", dict(possible_labels=["a", "b", "c"])),
                      (2, dict(possible_labels=[1, 2])),
                      ([1, 3], dict(possible_labels=[],
                                    label_groups=[["1"], ["2", "3"]]))):
        assert label_operator(value, **kw) == jlabel_operator(value, **kw)


def test_correct_classification_bias_matches_jax(catnet):
    """The output bias set to the positive share's log-odds, the same leaf
    the JAX helper picks (the last small 1-d bias in tree order)."""
    from adell_mri_tpu.train.checkpoints import (
        correct_classification_bias as jcorrect,
    )

    c = catnet[2]
    labels = [1.0, 0.0, 0.0, 1.0, 0.0]
    # init's tree keeps the modules' order (a tree.map sorts the keys)
    params = c["jm"].init(jax.random.PRNGKey(0),
                          jnp.asarray(catnet["x"]))["params"]
    params = {k: v for k, v in params.items()}
    want = from_flax(jcorrect(params, labels))
    tm = tfactories.get_classification_network("cat", TINY)
    tm.load_state_dict({**tadn.batch_stats(tm), **from_flax(params)})
    params = dict(tm.named_parameters())
    assert correct_classification_bias(params, labels) == "Dense_3.bias"
    for k, v in want.items():
        assert torch.equal(params[k].detach(), v), k
