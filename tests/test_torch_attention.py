"""
The port's plain attention forward and backward against the JAX package's
flash-attention kernels, on the CPU.

The JAX side runs ``_flash_fwd_tiled`` and ``_flash_bwd_pallas`` in Pallas
interpret mode (``pl.pallas_call`` patched from the test, as
``tests/test_pallas_ops.py`` does) and ``attention_reference``. The port's
side runs on CPU tensors, where each wrapper takes its plain version, so
the formulas the CUDA kernels repeat are the ones compared here. Inputs
come from numpy with a seed. Tolerances (f32 on both sides, sums in
different orders): 2e-5 forward, 1e-4 backward, relative to the largest
reference value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import adell_mri_tpu.ops.pallas.attention as jattn
from adell_mri_torch.ops.kernels import attention as tattn

# (B, H, Nq, Nkv, D): equal lengths, Nq != Nkv, and lengths that leave a
# partial last block on the JAX side (Nq > 512, Nkv > 1024)
SHAPES = [
    (1, 2, 128, 128, 32),
    (2, 2, 96, 200, 64),
    (1, 1, 600, 1100, 32),
]


@pytest.fixture()
def interpret_pallas(monkeypatch):
    real = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return real(*args, **kwargs)

    monkeypatch.setattr(jattn.pl, "pallas_call", patched)


def make_inputs(shape, seed):
    b, h, nq, nkv, d = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, nq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, nkv, d)).astype(np.float32)
    v = rng.normal(size=(b, h, nkv, d)).astype(np.float32)
    g = rng.normal(size=(b, h, nq, d)).astype(np.float32)
    return q, k, v, g


def rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_matches_jax_kernel(interpret_pallas, shape):
    q, k, v, _ = make_inputs(shape, 0)
    scale = shape[-1] ** -0.5
    want = jattn._flash_fwd_tiled(*map(jnp.asarray, (q, k, v)), scale)
    got = tattn.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)))
    for name, g_, w_ in zip(("out", "m", "l"), got, want):
        assert tuple(g_.shape) == tuple(w_.shape), name
        assert rel_err(g_.numpy(), w_) < 2e-5, name
    ref = jattn.attention_reference(*map(jnp.asarray, (q, k, v)))
    assert rel_err(got[0].numpy(), ref) < 2e-5
    assert rel_err(
        tattn.attention_reference(*map(torch.from_numpy, (q, k, v))).numpy(),
        ref,
    ) < 2e-5


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_backward_matches_jax_kernels(interpret_pallas, shape):
    """dq, dk, dv of the autograd Function against ``_flash_bwd_pallas`` fed
    the JAX forward's own (out, m, l), and against the gradient of
    ``attention_reference``."""
    q, k, v, g = make_inputs(shape, 1)
    scale = shape[-1] ** -0.5
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out, m, l = jattn._flash_fwd_tiled(jq, jk, jv, scale)
    want = jattn._flash_bwd_pallas(jq, jk, jv, out, m, l, jg, scale)
    _, vjp = jax.vjp(jattn.attention_reference, jq, jk, jv)
    ref = vjp(jg)

    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    y = tattn.flash_attention(*leaves)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, leaves, torch.from_numpy(g))
    for name, g_, w_, r_ in zip(("dq", "dk", "dv"), got, want, ref):
        assert tuple(g_.shape) == tuple(w_.shape), name
        assert rel_err(g_.numpy(), w_) < 1e-4, name
        assert rel_err(g_.numpy(), r_) < 1e-4, name


def test_backward_kernels_plain_versions_take_forward_rows():
    """The two backward wrappers, called as the Function calls them, agree
    with autograd through the plain materialised attention."""
    q, k, v, g = map(torch.from_numpy, make_inputs((1, 2, 70, 90, 32), 2))
    scale = 0.3
    out, m, l = tattn.flash_attention_fwd(q, k, v, scale)
    lse, delta = tattn.backward_rows(out, m, l, g)
    dq = tattn.flash_attention_bwd_dq(q, k, v, g, lse, delta, scale)
    dk, dv = tattn.flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        tattn.attention_reference(*leaves, scale=scale), leaves, g
    )
    for got, w_ in zip((dq, dk, dv), want):
        assert rel_err(got.numpy(), w_.numpy()) < 1e-4


def test_bf16_plain_version_rounds_like_the_kernels():
    """bf16 inputs: exact products summed in f32, p rounded to bf16 before
    the second product, the output in bf16; close to the f32 result."""
    q, k, v, _ = make_inputs((1, 2, 64, 80, 32), 3)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out, m, l = tattn.flash_attention_fwd(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    assert m.dtype == l.dtype == torch.float32
    want = tattn.attention_reference(tq.float(), tk.float(), tv.float())
    assert float((out.float() - want).abs().max()) < 2e-2
    assert tattn.flash_attention(tq, tk, tv).dtype == torch.bfloat16


def test_launch_counters_do_not_move_on_the_cpu():
    q, k, v, g = map(torch.from_numpy, make_inputs((1, 1, 16, 16, 32), 4))
    before = (
        tattn.flash_attention_fwd.launches,
        tattn.flash_attention_bwd_dq.launches,
        tattn.flash_attention_bwd_dkv.launches,
    )
    leaves = [t.requires_grad_() for t in (q, k, v)]
    torch.autograd.grad(tattn.flash_attention(*leaves), leaves, g)
    assert before == (
        tattn.flash_attention_fwd.launches,
        tattn.flash_attention_bwd_dq.launches,
        tattn.flash_attention_bwd_dkv.launches,
    )


def test_wrapper_refuses_other_devices():
    q = torch.zeros((1, 1, 4, 32), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tattn.flash_attention_fwd(q, q, q)


@pytest.mark.parametrize(
    "case",
    ["head_dim", "rank", "kv_mismatch", "dtype", "strided", "rows"],
)
def test_check_refuses_what_the_kernels_do_not_take(case):
    """The checks a CUDA call runs before it launches (they need no card)."""
    q = torch.zeros((1, 2, 8, 64))
    k = torch.zeros((1, 2, 12, 64))
    v = torch.zeros((1, 2, 12, 64))
    rows = [torch.zeros((1, 2, 8, 1))]
    err = ValueError
    if case == "head_dim":
        q, k, v = (torch.zeros((1, 2, 8, 48)) for _ in range(3))
    elif case == "rank":
        q = torch.zeros((2, 8, 64))
    elif case == "kv_mismatch":
        v = torch.zeros((1, 2, 10, 64))
    elif case == "dtype":
        k, err = k.half(), TypeError
    elif case == "strided":
        q = torch.zeros((1, 8, 2, 64)).transpose(1, 2)
    elif case == "rows":
        rows = [torch.zeros((1, 2, 8))]
    with pytest.raises(err):
        tattn._check("flash_attention", q, k, v, rows)
    tattn._check(
        "flash_attention", torch.zeros((1, 2, 8, 64)),
        torch.zeros((1, 2, 12, 64)), torch.zeros((1, 2, 12, 64)),
        [torch.zeros((1, 2, 8, 1))],
    )


@pytest.mark.parametrize("scale", [0.0, -0.125, float("nan"), float("inf")])
def test_check_refuses_a_scale_that_is_not_positive(scale):
    """The Hopper kernels take the row maximum before they scale."""
    q = torch.zeros((1, 2, 8, 64))
    k = torch.zeros((1, 2, 12, 64))
    with pytest.raises(ValueError, match="positive finite scale"):
        tattn._check("flash_attention", q, k, k, scale=scale)
    tattn._check("flash_attention", q, k, k, scale=0.125)


# (stem, dtype, D) -> dynamic shared memory of a block, from the layouts of
# csrc/flash_attention.cu worked out by hand
PLAN_SMEM = {
    ("fwd", torch.bfloat16, 64): 3 * 2 * 8192 + 1024,
    ("fwd", torch.bfloat16, 32): 3 * 2 * 4096 + 1024,
    ("bwd_dkv", torch.bfloat16, 64): 2 * 8192 + 4 * (2 * 8192 + 512) + 1024,
    ("bwd_dkv", torch.bfloat16, 32): 2 * 4096 + 4 * (2 * 4096 + 512) + 1024,
    ("bwd_dq", torch.bfloat16, 64): 3 * 2 * 8192 + 1024,
    ("bwd_dq", torch.bfloat16, 32): 3 * 2 * 4096 + 1024,
    ("bwd_dq", torch.float32, 64): 4 * 16640 + 2 * 17408 + 16640 + 17408,
    ("fwd", torch.float32, 64): 101632,
    ("bwd_dkv", torch.float32, 64): 4 * 16640 + 4 * 17408 + 2 * 16640,
}


@pytest.mark.parametrize("key", list(PLAN_SMEM), ids=str)
def test_launch_plan_sizes(key):
    stem, dtype, d = key
    plan = tattn.launch_plan(stem, dtype, 16, 2050, 2311, d)
    owned = 2311 if stem == "bwd_dkv" else 2050
    assert plan["grid"] == (-(-owned // 64), 16)
    assert (plan["rows"], plan["threads"]) == (64, 128)
    assert plan["smem"] == PLAN_SMEM[key]
    assert plan["smem"] <= tattn.MAX_SMEM


def test_hopper_kernels_fit_more_blocks_than_the_first_design():
    """Why the rewrite: 227 KB of shared memory an SM held one dK/dV block
    of the shared-memory design; the wgmma design fits two, the forward
    and dQ four."""
    sm = 233472
    for stem, blocks in (("fwd", 4), ("bwd_dq", 4), ("bwd_dkv", 2)):
        smem = tattn.launch_plan(stem, torch.bfloat16, 8, 2048, 2048,
                                 64)["smem"]
        assert sm // (smem + 1024) == blocks
    old_dkv = 124928
    assert sm // (old_dkv + 1024) == 1


@pytest.mark.parametrize("bad", ["stem", "head_dim", "dtype"])
def test_launch_plan_refuses_what_has_no_kernel(bad):
    args = dict(stem="fwd", dtype=torch.bfloat16, bh=1, n_q=8, n_kv=8, d=64)
    args.update({"stem": {"stem": "bwd"}, "head_dim": {"d": 128},
                 "dtype": {"dtype": torch.float16}}[bad])
    with pytest.raises(ValueError):
        tattn.launch_plan(**args)
