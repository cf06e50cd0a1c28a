"""
The port's ViT classifiers against the JAX package's, on the CPU:
``SeqPool``, ``FactorizedViT``, ``ViTClassifier`` in each pooling mode
(sequence pooling, the class token, the token mean) and with the exact
``mlp_structure``, ``FactorizedViTClassifier``, the factory's tree for
``sample_configs/classification-vit.yaml`` as it stands, and one
``make_classification_step`` step of each.

Tiny shapes (16x16x8 volumes, widths 32-64), seeded numpy inputs and
parameters (``random_flax_params``'s draw) moved into the port through
``from_flax``. One case takes the flash branch above a lowered
``FLASH_MIN_TOKENS`` with the class token, at a ragged token count (64
patches + 1): the JAX side runs its Pallas kernels in interpret mode,
the port its plain versions, which CPU tensors take. Tolerances: f32
forwards 1e-5 of the output's scale; a step's loss 1e-5 relative and
each gradient 2e-4 of its own scale (``step_matches_jax``: a gradient
that is zero but for rounding stays so; one whose f32 sum cancels is
held in f64, its f32 value within twice the JAX f32 step's distance),
dropout at 0.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adell_mri_tpu.models.layers.vit as jvit
from adell_mri_tpu.config import factories as jfactories
from adell_mri_tpu.models.classification import losses as jlosses
from adell_mri_tpu.train import steps as jsteps
import adell_mri_torch.models.layers.vit as tvit
from adell_mri_torch.config import factories as tfactories
from adell_mri_torch.config.parsing import parse_config_cat
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.classification import losses as tlosses
from adell_mri_torch.models.layers import adn as tadn
from adell_mri_torch.train import steps as tsteps
from test_torch_classification import _close as _close_tol
from test_torch_classifiers import _from_flax64
from test_torch_unet import random_flax_params
from test_torch_vit import flash_on_cpu  # noqa: F401 (a fixture)

SHAPE = (16, 16, 8)
CONFIGS = Path(__file__).resolve().parents[1] / "sample_configs"
VIT = dict(patch_size=[4, 4, 2], embedding_size=32, number_of_blocks=2,
           n_heads=2)
# case -> (net type, network config)
CASES = {
    "class_token": ("vit", dict(VIT, mlp_structure=[24])),
    "seq_pool": ("vit", dict(VIT, use_seq_pool=True)),
    "token_mean": ("vit", dict(VIT, use_class_token=False, embed_norm=True,
                               mlp_ratio=2.0)),
    "mlp_two_layers": ("vit", dict(VIT, mlp_structure=[40, 24])),
    "factorized": ("factorized_vit", dict(patch_size=[4, 4], embed_dim=32,
                                          n_blocks=3, n_heads=2)),
    "factorized_one_block": ("factorized_vit", dict(
        patch_size=[8, 4, 2], embedding_size=32, n_blocks=1, n_heads=4)),
}


def _x(b=2, seed=0, shape=SHAPE):
    return np.random.default_rng(seed).uniform(
        size=(b,) + shape + (1,)).astype(np.float32)


def _close(got, want, tol=1e-5):
    _close_tol(got, want, tol)


def build(net_type, cfg, n_classes=2, x=None, seed=1, batch_stats=False):
    """The JAX network and its parameters (and running statistics drawn
    from a seed), and the port's network with them loaded."""
    x = _x() if x is None else x
    jm = jfactories.get_classification_network(net_type, cfg,
                                               n_classes=n_classes)
    params = random_flax_params(jm, jnp.asarray(x), seed=seed)
    bs = {}
    if batch_stats:
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.asarray(x))
        rng = np.random.default_rng(seed + 1)
        bs = jax.tree.map(lambda s: rng.uniform(0.5, 1.5, s.shape).astype(
            np.float32), shapes.get("batch_stats", {}))
    tm = tfactories.get_classification_network(
        net_type, cfg, n_classes=n_classes, image_size=x.shape[1:-1])
    state = from_flax(params, bs)
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)
    return jm, params, bs, tm.eval()


def _jax_step(jm, loss_fn, n_classes, params, bs, batch, dtype):
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)
    jlm = jsteps.make_classification_step(jm, loss_fn, n_classes=n_classes)
    return jax.value_and_grad(jlm, has_aux=True)(
        cast(params), cast(batch), jax.random.PRNGKey(2),
        variables={"batch_stats": cast(bs)} if bs else None)


def _port_step(tm, loss_fn, n_classes, batch, dtype):
    model = tm.to(dtype)
    tlm = tsteps.make_classification_step(model, loss_fn,
                                          n_classes=n_classes)
    tparams = dict(model.named_parameters())
    tl, tmet = tlm({**tparams, **tadn.batch_stats(model)},
                   {k: torch.from_numpy(v).to(dtype)
                    for k, v in batch.items()})
    grads = torch.autograd.grad(tl, list(tparams.values()))
    return tl, tmet, dict(zip(tparams, grads))


def step_matches_jax(jm, params, bs, tm, batch, n_classes, loss_fn=None,
                     tloss_fn=None):
    """One ``make_classification_step`` training step of each package on
    the same batch: the loss within 1e-5 relative, the accuracy, the
    running statistics (where there are batch norms) within 1e-5, every
    gradient within 2e-4 of its own scale; one below 1e-5 of the step's
    largest gradient (zero but for rounding) stays below that on the
    port's side. Where an f32 gradient misses (a sum that cancels below
    what f32 resolves), both steps run again in f64: the port's f64
    gradient is held within 2e-4 of the JAX f64 one, and its f32 one
    within the larger of 2e-4 and twice the JAX f32 step's distance from
    it."""
    if loss_fn is None:
        loss_fn, tloss_fn = ((jlosses.binary_logistic_loss,
                              tlosses.binary_logistic_loss)
                             if n_classes == 2 else
                             (jlosses.cross_entropy_loss,
                              tlosses.cross_entropy_loss))
    (jl, jmet), jgrads = _jax_step(jm, loss_fn, n_classes, params, bs,
                                   batch, jnp.float32)
    tl, tmet, grads = _port_step(tm, tloss_fn, n_classes, batch,
                                 torch.float32)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    assert abs(float(tmet["acc"]) - float(jmet["acc"])) < 1e-6
    if bs:
        want = from_flax({}, jmet["_variables"]["batch_stats"])
        assert set(tmet["_variables"]) == set(want)
        for k, w in want.items():
            g = tmet["_variables"][k].detach()
            assert float((g - w).abs().max()) <= 1e-5 * max(
                float(w.abs().max()), 1e-3), k
    want = from_flax(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    missed = []
    for k, w in want.items():
        own = float(w.abs().max())
        if own < 1e-5 * scale:
            # zero but for rounding (a bias the softmax or a norm cancels)
            assert float(grads[k].abs().max()) < 1e-5 * scale, k
        elif float((grads[k] - w).abs().max()) > 2e-4 * own:
            missed.append(k)
    if not missed:
        return
    with jax.enable_x64(True):
        _, jgrads64 = _jax_step(jm, loss_fn, n_classes, params, bs, batch,
                                jnp.float64)
        ref = _from_flax64(jax.tree.map(np.asarray, jgrads64))
    grads64 = _port_step(tm, tloss_fn, n_classes, batch, torch.float64)[2]
    tm.float()
    for k in missed:
        own = float(ref[k].abs().max())
        assert float((grads64[k] - ref[k]).abs().max()) <= 2e-4 * own, k
        err = float((grads[k].double() - ref[k]).abs().max())
        jerr = float((want[k].double() - ref[k]).abs().max())
        assert err <= max(2e-4 * own, 2 * jerr), (k, err / own, jerr / own)


def test_seq_pool_matches_jax():
    x = np.random.default_rng(3).normal(size=(3, 11, 24)).astype(np.float32)
    jm = jvit.SeqPool()
    params = random_flax_params(jm, jnp.asarray(x), seed=4)
    tm = tvit.SeqPool(24)
    tm.load_state_dict(from_flax(params))
    _close(tm(torch.from_numpy(x)), jm.apply({"params": params},
                                             jnp.asarray(x)))


@pytest.mark.parametrize("n_blocks", [1, 2, 5])
def test_factorized_vit_matches_jax(n_blocks):
    """Both stacks' depths (``n_blocks // 2 or 1`` within the slices, the
    rest between them), the slice class token and the sinusoidal slice
    positions; tokens [B, D + 1, E]."""
    x = _x(seed=5)
    jm = jvit.FactorizedViT(patch_size=(4, 4), embed_dim=32,
                            n_blocks=n_blocks, n_heads=2)
    params = random_flax_params(jm, jnp.asarray(x), seed=6)
    tm = tvit.FactorizedViT(1, SHAPE, (4, 4), embed_dim=32,
                            n_blocks=n_blocks, n_heads=2)
    tm.load_state_dict(from_flax(params))
    want = jm.apply({"params": params}, jnp.asarray(x))
    assert want.shape == (2, SHAPE[2] + 1, 32)
    _close(tm.eval()(torch.from_numpy(x)), want)
    assert tm.within_slice.n_blocks == max(n_blocks // 2, 1)
    assert tm.between_slice.n_blocks == max(n_blocks - n_blocks // 2, 1)


@pytest.mark.parametrize("n_classes", [2, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_classifier_matches_jax(case, n_classes):
    """The logits in eval, f32, 1e-5 of their scale."""
    net_type, cfg = CASES[case]
    x = _x(seed=7)
    jm, params, _, tm = build(net_type, cfg, n_classes, x)
    want = jm.apply({"params": params}, jnp.asarray(x))
    assert want.shape == (2, 1 if n_classes == 2 else n_classes)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), want)


def test_ragged_flash_branch_matches_jax(flash_on_cpu):  # noqa: F811
    """The class token makes 65 tokens above the lowered threshold: both
    sides take their flash branch (the JAX Pallas kernels in interpret
    mode, the port's plain versions) at a count that is no multiple of a
    tile, each block once."""
    x = _x(seed=8)
    cfg = dict(patch_size=[4, 4, 2], embed_dim=64, n_blocks=2, n_heads=2)
    jm, params, _, tm = build("vit", cfg, 2, x, seed=9)
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), want)
    assert flash_on_cpu == [(2, 2, 65, 32)] * 2


def test_yaml_tree_matches_jax():
    """``classification-vit.yaml`` as it stands (16x16x4 patches, 768
    wide, 10 blocks of 12 heads, MLP [1024], dropout 0.1): the port's tree
    has the JAX tree's names and shapes, the MLP's exact widths among
    them; the yaml's ``learnable_embedding`` and ``weight_decay`` keys
    reach neither network."""
    cfg = parse_config_cat(str(CONFIGS / "classification-vit.yaml"))[
        "network"]
    shape = (32, 32, 8)
    jm = jfactories.get_classification_network("vit", cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + shape + (1,)))["params"]
    want = from_flax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes))
    tm = tfactories.get_classification_network("vit", cfg, image_size=shape)
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
    block = tm.ViT_0.TransformerBlockStack_0
    assert block.n_blocks == 10
    assert tuple(got["ViT_0.TransformerBlockStack_0.block_9.Dense_0.weight"]
                 .shape) == (1024, 768)
    assert tuple(got["ViT_0.LinearEmbedding_0.pos_embedding"].shape) == (
        1, 8, 768)
    assert block.block_0.MultiHeadAttention_0.dropout.p == 0.1


@pytest.mark.parametrize("case", ["class_token", "seq_pool", "token_mean",
                                  "factorized"])
def test_classification_step_matches_jax(case):
    """One training step (binary labels; the multiclass head for
    ``factorized``) at dropout 0."""
    net_type, cfg = CASES[case]
    n_classes = 3 if case == "factorized" else 2
    x = _x(b=4, seed=10)
    jm, params, _, tm = build(net_type, cfg, n_classes, x, seed=11)
    y = (np.asarray([0, 1, 2, 1]) if n_classes == 3
         else np.asarray([0, 1, 1, 0])).astype(np.float32)
    step_matches_jax(jm, params, {}, tm, {"image": x, "label": y},
                     n_classes)


def test_image_size_is_required():
    with pytest.raises(ValueError, match="image_size"):
        tfactories.get_classification_network("vit", {})
    with pytest.raises(NotImplementedError, match="not ported"):
        tfactories.get_classification_network(
            "vit", {"moe_experts": 2}, image_size=SHAPE)
