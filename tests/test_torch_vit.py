"""
The port's transformer layers against the JAX package's, on the CPU.

Each JAX module's parameters are drawn from a seeded numpy generator and
moved into the port through ``from_flax``; the same numpy input goes
through both. The flash branch of ``MultiHeadAttention`` is reached by
lowering ``FLASH_MIN_TOKENS`` on both sides from the test (the JAX side
then runs its Pallas kernels in interpret mode, the port its plain
versions, which CPU tensors take). Tolerance 1e-5 relative to the output's
scale: f32 on both sides, sums in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import adell_mri_tpu.models.layers.vit as jvit
import adell_mri_tpu.ops.pallas.attention as jattn
import adell_mri_torch.models.layers.vit as tvit
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.ops.kernels import attention as tattn
from test_torch_unet import random_flax_params


def _numpy(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def _load(tmod, params):
    state = from_flax(params)
    assert set(state) == set(tmod.state_dict())
    tmod.load_state_dict(state)
    return tmod.eval()


@pytest.fixture()
def flash_on_cpu(monkeypatch):
    """Both sides take their flash branch from 32 tokens on."""
    real = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return real(*args, **kwargs)

    monkeypatch.setattr(jattn.pl, "pallas_call", patched)
    monkeypatch.setenv("ADELL_PALLAS_FORCE", "1")
    monkeypatch.setattr(jvit, "FLASH_MIN_TOKENS", 32)
    monkeypatch.setattr(tvit, "FLASH_MIN_TOKENS", 32)
    calls = []
    real_flash = tvit.flash_attention

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real_flash(*args, **kwargs)

    monkeypatch.setattr(tvit, "flash_attention", counted)
    return calls


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(n_heads=4),
        dict(n_heads=2, head_dim=32),
        dict(n_heads=4, qk_norm=False),
    ],
    ids=["default", "head_dim", "no_qk_norm"],
)
def test_mha_materialised_branch_matches_jax(kwargs):
    x = _numpy((2, 20, 32), 0)
    jm = jvit.MultiHeadAttention(**kwargs)
    params = random_flax_params(jm, jnp.asarray(x), seed=1)
    tm = _load(tvit.MultiHeadAttention(32, **kwargs), params)
    want = jm.apply({"params": params}, jnp.asarray(x))
    _close(tm(torch.from_numpy(x)), want)


def test_mha_bias_and_cross_attention_match_jax():
    x, kv = _numpy((2, 12, 32), 2), _numpy((2, 9, 24), 3)
    bias = _numpy((2, 4, 12, 9), 4)
    jm = jvit.MultiHeadAttention(n_heads=4)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(kv))
    )["params"]
    rng = np.random.default_rng(5)
    params = jax.tree.map(
        lambda s: (0.2 * rng.normal(size=s.shape)).astype(np.float32), shapes
    )
    tm = _load(tvit.MultiHeadAttention(32, 4, kv_dim=24), params)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(kv),
                    jnp.asarray(bias))
    got = tm(torch.from_numpy(x), torch.from_numpy(kv),
             torch.from_numpy(bias))
    _close(got, want)


def test_mha_flash_branch_matches_jax(flash_on_cpu):
    x = _numpy((2, 48, 64), 6)
    jm = jvit.MultiHeadAttention(n_heads=2)
    params = random_flax_params(jm, jnp.asarray(x), seed=7)
    tm = _load(tvit.MultiHeadAttention(64, 2), params)
    want = jm.apply({"params": params}, jnp.asarray(x))
    _close(tm(torch.from_numpy(x)), want)
    assert flash_on_cpu == [(2, 2, 48, 32)]  # [B, H, N, Dh]
    # the same layer through the materialised softmax agrees with itself
    tm.use_flash = False
    _close(tm(torch.from_numpy(x)), want)
    assert len(flash_on_cpu) == 1


def test_mha_dispatch_conditions(flash_on_cpu):
    """The four conditions besides ``use_flash``: a bias, active dropout,
    a rank other than 3 and too few tokens leave the flash branch."""
    tm = tvit.MultiHeadAttention(32, 2, dropout=0.5).eval()
    x = torch.from_numpy(_numpy((1, 40, 32), 8))
    tm(x)
    assert len(flash_on_cpu) == 1
    tm(x, bias=torch.zeros((1, 2, 40, 40)))
    tm(x[:, :20])
    tm(x[None])
    tm.train()
    tm(x)
    assert len(flash_on_cpu) == 1
    # dropout 0 in training mode stays on the kernel path
    tvit.MultiHeadAttention(32, 2).train()(x)
    assert len(flash_on_cpu) == 2


def test_mha_flash_gradient_reaches_the_projections(flash_on_cpu):
    tm = tvit.MultiHeadAttention(64, 2)
    x = torch.from_numpy(_numpy((1, 40, 64), 9)).requires_grad_()
    before = tattn.flash_attention_bwd_dq.launches
    tm(x).square().sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    assert all(p.grad is not None and float(p.grad.abs().max()) > 0
               for p in tm.parameters())
    assert tattn.flash_attention_bwd_dq.launches == before  # CPU: plain


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(n_heads=4),
        dict(n_heads=4, mlp_ratio=2.0),
        dict(n_heads=2, mlp_structure=(24, 40)),
        dict(n_heads=4, attention_dim=64),
    ],
    ids=["default", "mlp_ratio", "mlp_structure", "attention_dim"],
)
def test_transformer_block_matches_jax(kwargs):
    x = _numpy((2, 10, 32), 10)
    jm = jvit.TransformerBlock(**kwargs)
    params = random_flax_params(jm, jnp.asarray(x), seed=11)
    tm = _load(tvit.TransformerBlock(32, **kwargs), params)
    _close(tm(torch.from_numpy(x)),
           jm.apply({"params": params}, jnp.asarray(x)))


def test_moe_block_is_not_ported():
    with pytest.raises(NotImplementedError):
        tvit.TransformerBlock(32, 4, moe_experts=2)


def test_stack_return_at_matches_jax():
    x = _numpy((2, 10, 32), 12)
    jm = jvit.TransformerBlockStack(n_blocks=4, n_heads=4)
    params = random_flax_params(jm, jnp.asarray(x), seed=13)
    tm = _load(tvit.TransformerBlockStack(32, 4, 4), params)
    want, want_inter = jm.apply(
        {"params": params}, jnp.asarray(x), return_at=[0, 2]
    )
    got, inter = tm(torch.from_numpy(x), return_at=[0, 2])
    _close(got, want)
    assert len(inter) == len(want_inter) == 2
    for g, w in zip(inter, want_inter):
        _close(g, w)
    _close(tm(torch.from_numpy(x)), want)


EMBEDDINGS = {
    "linear": dict(embed_method="linear"),
    "linear_norm": dict(embed_method="linear", embed_norm=True),
    "convolutional": dict(embed_method="convolutional"),
    "class_token_registers": dict(use_class_token=True, n_registers=3),
    "sinusoidal": dict(learnable_embedding=False),
    "channel_to_token": dict(channel_to_token=True),
}


@pytest.mark.parametrize("name", sorted(EMBEDDINGS))
def test_linear_embedding_matches_jax(name):
    kwargs = EMBEDDINGS[name]
    x = _numpy((2, 8, 8, 4, 3), 14)
    jm = jvit.LinearEmbedding(patch_size=(4, 2, 2), embed_dim=24, **kwargs)
    params = random_flax_params(jm, jnp.asarray(x), seed=15)
    tm = _load(
        tvit.LinearEmbedding(3, (8, 8, 4), (4, 2, 2), embed_dim=24, **kwargs),
        params,
    )
    _close(tm(torch.from_numpy(x)),
           jm.apply({"params": params}, jnp.asarray(x)))


def test_linear_embedding_2d_linear_matches_jax():
    x = _numpy((2, 8, 6, 2), 16)
    jm = jvit.LinearEmbedding(patch_size=(2, 3), embed_dim=16)
    params = random_flax_params(jm, jnp.asarray(x), seed=17)
    tm = _load(tvit.LinearEmbedding(2, (8, 6), (2, 3), embed_dim=16), params)
    _close(tm(torch.from_numpy(x)),
           jm.apply({"params": params}, jnp.asarray(x)))


def test_vit_matches_jax():
    x = _numpy((2, 8, 8, 4, 1), 18)
    kwargs = dict(patch_size=(4, 4, 2), embed_dim=32, n_blocks=2, n_heads=4,
                  use_class_token=True)
    jm = jvit.ViT(**kwargs)
    params = random_flax_params(jm, jnp.asarray(x), seed=19)
    tm = _load(tvit.ViT(1, (8, 8, 4), **kwargs), params)
    _close(tm(torch.from_numpy(x)),
           jm.apply({"params": params}, jnp.asarray(x)))


def test_sinusoidal_positions_match_jax():
    for n, dim in ((7, 16), (5, 9)):
        np.testing.assert_allclose(
            tvit.sinusoidal_positions(n, dim).numpy(),
            np.asarray(jvit.sinusoidal_positions(n, dim)), atol=1e-6,
        )


def test_dropout_draws_from_its_generator():
    from adell_mri_torch.models.layers.dropout import Dropout, seed_dropout

    tm = tvit.TransformerBlock(32, 4, dropout=0.5).train()
    x = torch.from_numpy(_numpy((2, 10, 32), 20))
    outs = []
    for _ in range(2):
        n = seed_dropout(tm, torch.Generator().manual_seed(3))
        outs.append(tm(x))
    assert n == 2  # attention and MLP
    assert torch.equal(outs[0], outs[1])
    seed_dropout(tm, torch.Generator().manual_seed(4))
    assert not torch.equal(tm(x), outs[0])
    assert torch.equal(tm.eval()(x), tm(x))
    drop = Dropout(0.25).train()
    kept = drop(torch.ones(100000))
    assert abs(float((kept > 0).float().mean()) - 0.75) < 0.01
    assert abs(float(kept.mean()) - 1.0) < 0.02
