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
# csrc/flash_attention.cu worked out by hand; f32 (3xTF32): a ring of
# images of 32-row tiles (forward: 3 stages of K and V^T, each panel 128 D
# bytes big and as many small; dQ: 3 stages of K, V and K^T; dK/dV: 2
# stages of Q, dO, Q^T, dO^T and 1024 bytes of lse and delta), raw A
# operands of 128 rows of D + 4 f32 (one in the forward, two in the
# backward), 1024 bytes of alignment
PLAN_SMEM = {
    ("fwd", torch.bfloat16, 64): 3 * 2 * 8192 + 1024,
    ("fwd", torch.bfloat16, 32): 3 * 2 * 4096 + 1024,
    ("bwd_dkv", torch.bfloat16, 64): 2 * 8192 + 4 * (2 * 8192 + 512) + 1024,
    ("bwd_dkv", torch.bfloat16, 32): 2 * 4096 + 4 * (2 * 4096 + 512) + 1024,
    ("bwd_dq", torch.bfloat16, 64): 3 * 2 * 8192 + 1024,
    ("bwd_dq", torch.bfloat16, 32): 3 * 2 * 4096 + 1024,
    ("bwd_dq", torch.float32, 64): 3 * 6 * 8192 + 2 * 128 * 68 * 4 + 1024,
    ("fwd", torch.float32, 64): 3 * 4 * 8192 + 128 * 68 * 4 + 1024,
    ("bwd_dkv", torch.float32, 64): (2 * (8 * 8192 + 1024)
                                     + 2 * 128 * 68 * 4 + 1024),
}
# (stem, dtype) -> rows a block owns, threads, rows of a streamed tile and
# bytes of its image at D = 64: two warpgroups and 32-row images in f32,
# one warpgroup and 64-row tiles in bf16
PLAN_BLOCK = {
    ("fwd", torch.float32): (128, 256, 32, 4 * 8192),
    ("bwd_dq", torch.float32): (128, 256, 32, 6 * 8192),
    ("bwd_dkv", torch.float32): (128, 256, 32, 8 * 8192 + 1024),
}


@pytest.mark.parametrize("key", list(PLAN_SMEM), ids=str)
def test_launch_plan_sizes(key):
    stem, dtype, d = key
    plan = tattn.launch_plan(stem, dtype, 16, 2050, 2311, d)
    owned = 2311 if stem == "bwd_dkv" else 2050
    rows, threads, tile, image = PLAN_BLOCK.get((stem, dtype),
                                                (64, 128, 64, 0))
    assert plan["grid"] == (-(-owned // rows), 16)
    assert (plan["rows"], plan["threads"]) == (rows, threads)
    assert (plan["tile"], plan["image"]) == (tile, image)
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


# -- the 3xTF32 kernels (f32): their arithmetic, emulated in numpy -----------
#
# The CUDA kernels run only on the card; what they compute is pinned here:
# the preparation's images (through ``flash_tf32x3_image_reference``, the
# preparation kernel's plain version, which the card tests hold the kernel
# to bit for bit), what ``wgmma`` reads from them through a 128-byte
# swizzle descriptor, the A fragments the kernels make of their f32 sums,
# the three TF32 products and the tensor-core sums of SUM_TILES stream
# tiles (one tile in the forward, whose sums are rescaled every tile) added
# to f32 sums. Products of TF32 values are exact in float64, so
# an ideal tensor-core sum is the float64 sum rounded once to f32.

TILE = tattn.TF32X3_TILE
SUM_TILES = 2
#: A fragment register r of k-step j is sum register 4 j + FRAG[r]
#: (flash_attention.cu: sums_fragment)
FRAG = np.array([0, 2, 1, 3])


def _tf32(a):
    """``cvt.rna.tf32.f32`` in numpy."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _read_panel(half, rows, cols):
    """The logical ``[rows, cols]`` K-major operand that ``wgmma`` reads
    from one half of a panel through a 128-byte-swizzle descriptor:
    ``cols / 32`` sub-tiles of ``rows`` rows of 128 bytes, k-step j at byte
    32 (j % 4) of the rows of sub-tile j // 4; the card finds logical chunk
    c of row n at chunk c ^ (n % 8)."""
    n = np.arange(rows)[:, None]
    kc = np.arange(cols)[None, :]
    pos = (kc // 32 * rows * 32 + n * 32 + ((kc % 32 // 4) ^ (n % 8)) * 4
           + kc % 4)
    return half[pos]


def _fragment_operand(sums):
    """The logical A operand ``[64, 32]`` (m, k) that TF32 ``wgmma`` sees
    when a warpgroup hands it its 64 x 32 f32 sums through FRAG: sum
    register i of lane l of warp w is element (16 w + l / 4 + 8 ((i / 2) %
    2), 8 (i / 4) + 2 (l % 4) + i % 2) (wgmma.cuh), A register r of k-step
    j is element (16 w + l / 4 + 8 (r % 2), 8 j + l % 4 + 4 (r / 2))."""
    w, lane, j, r = np.meshgrid(np.arange(4), np.arange(32), np.arange(4),
                                np.arange(4), indexing="ij")
    i = 4 * j + FRAG[r]
    out = np.full((64, 32), np.nan, np.float32)
    out[16 * w + lane // 4 + 8 * (r % 2), 8 * j + lane % 4 + 4 * (r // 2)] = (
        sums[16 * w + lane // 4 + 8 * (i // 2 % 2),
             8 * (i // 4) + 2 * (lane % 4) + i % 2])
    return out


def _products(a, big, small, passes=3):
    """sum_k a[m, k] b[n, k] as the kernels take it: a split into TF32
    halves in registers, b the image's halves; three TF32 products (or
    only big * big), summed exactly."""
    ab = _tf32(a).astype(np.float64)
    a_s = _tf32(a - _tf32(a)).astype(np.float64)
    big, small = big.astype(np.float64), small.astype(np.float64)
    out = ab @ big.T
    if passes == 3:
        out += a_s @ big.T + ab @ small.T
    return out


def _rows_of(x, r0, rows=64):
    """Rows r0 .. r0 + rows - 1 of x, zeros past its end."""
    out = np.zeros((rows,) + x.shape[1:], np.float32)
    part = x[r0:r0 + rows]
    out[:len(part)] = part
    return out


def emulate_bwd_dq(q, k, v, g, lse, delta, scale, passes=3):
    """dq of ``flash_bwd_dq_tf32x3_kernel``, all arrays numpy f32
    ``[B, H, N, D]`` (lse, delta ``[B, H, Nq, 1]``)."""
    b, h, nq, d = q.shape
    nkv = k.shape[2]
    img = tattn.flash_tf32x3_image_reference(
        0, torch.from_numpy(k), torch.from_numpy(v)).numpy()
    half = 32 * d  # floats of a panel's half
    c = np.float32(scale * np.log2(np.e))
    dq = np.zeros_like(q)
    flat = [x.reshape(b * h, x.shape[2], x.shape[3])
            for x in (q, g, lse, delta)]
    for bh in range(b * h):
        for r0 in range(0, nq, 64):  # a warpgroup's rows
            qw, gw, lw, dw = (_rows_of(x[bh], r0) for x in flat)
            acc = np.zeros((64, d), np.float32)
            for u in range(img.shape[1]):
                im = img[bh, u]
                panel = [_read_panel(im[i * half:(i + 1) * half], 32, d)
                         for i in range(4)]
                s = _products(qw, panel[0], panel[1], passes).astype(
                    np.float32)
                dp = _products(gw, panel[2], panel[3], passes).astype(
                    np.float32)
                p = np.exp2(s * c - lw * np.float32(np.log2(np.e)))
                ds = p * (dp - dw) * np.float32(scale)
                ds[:, nkv - u * TILE:] = 0.0
                kt = [_read_panel(im[i * half:(i + 1) * half], d, 32)
                      for i in (4, 5)]
                got = _products(_fragment_operand(ds), kt[0], kt[1], passes)
                part = got if u % SUM_TILES == 0 else part + got
                if u % SUM_TILES == SUM_TILES - 1 or u == img.shape[1] - 1:
                    acc += part.astype(np.float32)
            dq.reshape(b * h, nq, d)[bh, r0:r0 + 64] = acc[:nq - r0]
    return dq


def emulate_bwd_dkv(q, k, v, g, lse, delta, scale, passes=3):
    """(dk, dv) of ``flash_bwd_dkv_tf32x3_kernel``, as above."""
    b, h, nq, d = q.shape
    nkv = k.shape[2]
    img = tattn.flash_tf32x3_image_reference(
        1, *map(torch.from_numpy, (q, g, lse, delta))).numpy()
    half = 32 * d
    c = np.float32(scale * np.log2(np.e))
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    kf, vf = k.reshape(b * h, nkv, d), v.reshape(b * h, nkv, d)
    for bh in range(b * h):
        for r0 in range(0, nkv, 64):
            kw, vw = _rows_of(kf[bh], r0), _rows_of(vf[bh], r0)
            acc_k = np.zeros((64, d), np.float32)
            acc_v = np.zeros((64, d), np.float32)
            for t in range(img.shape[1]):
                im = img[bh, t]
                nat = [_read_panel(im[i * half:(i + 1) * half], 32, d)
                       for i in range(4)]
                tr = [_read_panel(im[i * half:(i + 1) * half], d, 32)
                      for i in range(4, 8)]
                rows = im[8 * half:8 * half + 2 * TILE]
                s_t = _products(kw, nat[0], nat[1], passes).astype(np.float32)
                dp_t = _products(vw, nat[2], nat[3], passes).astype(
                    np.float32)
                p = np.exp2(s_t * c - rows[:TILE] * np.float32(np.log2(np.e)))
                ds = p * (dp_t - rows[TILE:]) * np.float32(scale)
                got_v = _products(_fragment_operand(p), tr[2], tr[3], passes)
                got_k = _products(_fragment_operand(ds), tr[0], tr[1], passes)
                if t % SUM_TILES == 0:
                    part_k, part_v = got_k, got_v
                else:
                    part_k, part_v = part_k + got_k, part_v + got_v
                if t % SUM_TILES == SUM_TILES - 1 or t == img.shape[1] - 1:
                    acc_k += part_k.astype(np.float32)
                    acc_v += part_v.astype(np.float32)
            n = min(64, nkv - r0)
            dk.reshape(b * h, nkv, d)[bh, r0:r0 + n] = acc_k[:n]
            dv.reshape(b * h, nkv, d)[bh, r0:r0 + n] = acc_v[:n]
    return dk, dv


def emulate_fwd(q, k, v, scale, passes=3):
    """(out, m, l) of ``flash_fwd_tf32x3_kernel``, numpy f32 ``[B, H, N,
    D]`` in: per stream tile, s = q k^T against the image's K panel, key
    columns past Nkv at -1e30, the online softmax (row maxima of the
    unscaled s, ``exp2`` with scale log2(e) folded in), then p v against
    the V^T panel with p handed over through the sums' fragment map, a
    fresh tensor-core sum added to the rescaled f32 sums."""
    b, h, nq, d = q.shape
    nkv = k.shape[2]
    img = tattn.flash_tf32x3_image_reference(
        2, torch.from_numpy(k), torch.from_numpy(v)).numpy()
    half = 32 * d
    c = np.float32(scale * np.log2(np.e))
    out = np.zeros((b * h, nq, d), np.float32)
    rows = np.zeros((2, b * h, nq, 1), np.float32)  # m, l
    qf = q.reshape(b * h, nq, d)
    for bh in range(b * h):
        for r0 in range(0, nq, 64):  # a warpgroup's rows
            qw = _rows_of(qf[bh], r0)
            m = np.full((64, 1), -1e30, np.float32)
            l = np.zeros((64, 1), np.float32)
            acc = np.zeros((64, d), np.float32)
            for u in range(img.shape[1]):
                im = img[bh, u]
                kp = [_read_panel(im[i * half:(i + 1) * half], 32, d)
                      for i in (0, 1)]
                vt = [_read_panel(im[i * half:(i + 1) * half], d, 32)
                      for i in (2, 3)]
                s = _products(qw, kp[0], kp[1], passes).astype(np.float32)
                s[:, nkv - u * TILE:] = np.float32(-1e30)
                m_new = np.maximum(m, s.max(axis=1, keepdims=True))
                alpha = np.exp2((m - m_new) * c)
                p = np.exp2(s * c - m_new * c)
                l = l * alpha + p.sum(axis=1, keepdims=True)
                part = _products(_fragment_operand(p), vt[0], vt[1], passes)
                acc = acc * alpha + part.astype(np.float32)
                m = m_new
            n = min(64, nq - r0)
            out[bh, r0:r0 + n] = (acc / np.maximum(l, 1e-30))[:n]
            rows[0, bh, r0:r0 + n] = (m * np.float32(scale))[:n]
            rows[1, bh, r0:r0 + n] = l[:n]
    return (out.reshape(q.shape), *rows.reshape(2, b, h, nq, 1))


def _jax_forward(shape, seed):
    """Inputs, ``_flash_fwd_tiled``'s (out, m, l) and the port's plain
    version's, all numpy."""
    q, k, v, _ = make_inputs(shape, seed)
    scale = shape[-1] ** -0.5
    want = [np.asarray(x) for x in
            jattn._flash_fwd_tiled(*map(jnp.asarray, (q, k, v)), scale)]
    plain = [x.numpy() for x in tattn.flash_attention_fwd_reference(
        *map(torch.from_numpy, (q, k, v)), scale)]
    return (q, k, v, scale), want, plain


def _fwd_errors(got, want):
    """Each of out, m, l over chip_smoke.py's f32 forward tolerance: out
    within 2e-5 and m within 1e-4 of their scales (floored at 1), l within
    1e-4 relative."""
    (out, m, l), (w_out, w_m, w_l) = got, want
    return (np.abs(out - w_out).max() / (2e-5 * max(np.abs(w_out).max(), 1)),
            np.abs(m - w_m).max() / (1e-4 * max(np.abs(w_m).max(), 1)),
            np.abs((l - w_l) / w_l).max() / 1e-4)


def _jax_backward(shape, seed):
    """Inputs, the JAX forward's rows, ``_flash_bwd_pallas``'s (dq, dk,
    dv) and the port's plain versions', all numpy."""
    q, k, v, g = make_inputs(shape, seed)
    scale = shape[-1] ** -0.5
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out, m, l = jattn._flash_fwd_tiled(jq, jk, jv, scale)
    want = [np.asarray(x) for x in
            jattn._flash_bwd_pallas(jq, jk, jv, out, m, l, jg, scale)]
    lse, delta = (x.numpy() for x in tattn.backward_rows(
        *(torch.from_numpy(np.array(x)) for x in (out, m, l)),
        torch.from_numpy(g)))
    args = [torch.from_numpy(x) for x in (q, k, v, g, lse, delta)]
    plain = [tattn.flash_attention_bwd_dq_reference(*args, scale).numpy(),
             *(x.numpy() for x in
               tattn.flash_attention_bwd_dkv_reference(*args, scale))]
    return (q, k, v, g, lse, delta, scale), want, plain


# (B, H, Nq, Nkv): either sequence at 1, 63, 64 and 65 rows, and a ragged
# pair with more than one warpgroup's rows and sum of stream tiles
TF32X3_SHAPES = [(1, 2, 1, 65), (1, 2, 63, 1), (1, 2, 64, 63),
                 (1, 2, 65, 64), (1, 2, 130, 97)]


def _held(got, want, floor):
    """Within 1e-4 of the output scale (chip_smoke.py's f32 backward
    tolerance); with a single key dq and dk vanish in exact arithmetic, so
    the scale has a floor of 1e-2 of dv's."""
    return rel_err(got, want) * np.abs(want).max() <= 1e-4 * max(
        np.abs(want).max(), floor)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("shape", TF32X3_SHAPES, ids=str)
def test_tf32x3_backward_emulation_matches_jax_and_plain(interpret_pallas,
                                                         shape, d):
    """The 3xTF32 kernels' arithmetic (images, swizzled reads, the sums'
    A fragments, three TF32 products, tensor-core sums of two stream tiles
    added to f32 sums) against ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` in
    interpret mode and against the port's plain versions."""
    args, want, plain = _jax_backward(shape + (d,), 30 + d)
    got = [emulate_bwd_dq(*args), *emulate_bwd_dkv(*args)]
    floor = 1e-2 * np.abs(plain[2]).max()
    for name, g_, w_, p_ in zip(("dq", "dk", "dv"), got, want, plain):
        assert g_.shape == w_.shape, name
        assert np.isfinite(g_).all(), name
        assert _held(g_, w_, floor), (name, rel_err(g_, w_))
        assert _held(g_, p_, floor), (name, rel_err(g_, p_))


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("shape", TF32X3_SHAPES, ids=str)
def test_tf32x3_forward_emulation_matches_jax_and_plain(interpret_pallas,
                                                        shape, d):
    """The 3xTF32 forward's arithmetic (the kind-2 image, swizzled reads,
    three TF32 products, the online softmax, p's A fragments, one tile's
    tensor-core sum a turn added to rescaled f32 sums) against
    ``_flash_kernel`` in interpret mode and the port's plain version."""
    args, want, plain = _jax_forward(shape + (d,), 20 + d)
    got = emulate_fwd(*args)
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape
        assert np.isfinite(g_).all()
    assert max(_fwd_errors(got, want)) <= 1.0, _fwd_errors(got, want)
    assert max(_fwd_errors(got, plain)) <= 1.0, _fwd_errors(got, plain)


def test_one_tf32_pass_does_not_hold_the_forward_bound(interpret_pallas):
    """Why three products in the forward: big * big alone misses 2e-5 of
    the output scale where 3xTF32 holds it."""
    args, _, plain = _jax_forward((1, 2, 130, 97, 64), 25)
    assert _fwd_errors(emulate_fwd(*args, passes=1), plain)[0] > 1.0
    assert _fwd_errors(emulate_fwd(*args), plain)[0] <= 1.0


def test_one_tf32_pass_does_not_hold_the_bound(interpret_pallas):
    """Why three products: big * big alone (one TF32 pass, 2^-11 of each
    operand) misses 1e-4 of the scale where 3xTF32 holds it."""
    args, _, plain = _jax_backward((1, 2, 130, 97, 64), 40)
    floor = 1e-2 * np.abs(plain[2]).max()
    one = [emulate_bwd_dq(*args, passes=1), *emulate_bwd_dkv(*args, passes=1)]
    assert not any(_held(g_, p_, floor) for g_, p_ in zip(one, plain))


@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("d", [32, 64])
def test_tf32x3_image_layout(kind, d):
    """``flash_tf32x3_image_reference``: per 32-row tile the panels a, b,
    a^T (and b^T, then lse and delta, for kind 1; a and b^T for kind 2, the
    forward's), each big = tf32(x) then
    small = tf32(x - big), which sum to x within 2^-21 of its magnitude;
    read through the swizzle, a natural panel is the tile, a transposed one
    the tile transposed with the rows of each group of 8 in the order 0, 2,
    4, 6, 1, 3, 5, 7; rows past the end are zeros."""
    rng = np.random.default_rng(50 + kind + d)
    n = 70
    a, b_ = (rng.normal(size=(1, 2, n, d)).astype(np.float32)
             for _ in range(2))
    lse, delta = (rng.normal(size=(1, 2, n, 1)).astype(np.float32)
                  for _ in range(2))
    img = tattn.flash_tf32x3_image_reference(
        kind, *map(torch.from_numpy, (a, b_, lse, delta))).numpy()
    plan = tattn.launch_plan(("bwd_dq", "bwd_dkv", "fwd")[kind],
                             torch.float32, 2, n, n, d)
    assert img.shape == (2, 3, plan["image"] // 4)
    half = 32 * d
    perm = np.array([0, 2, 4, 6, 1, 3, 5, 7])
    panels = [[(a, False), (b_, False), (a, True)],
              [(a, False), (b_, False), (a, True), (b_, True)],
              [(a, False), (b_, True)]][kind]
    for bh in range(2):
        for t in range(3):
            im = img[bh, t]
            assert not (im.view(np.uint32)[:2 * len(panels) * half]
                        & 0x1FFF).any()
            for i, (x, trans) in enumerate(panels):
                tile = _rows_of(x.reshape(2, n, d)[bh], 32 * t, 32)
                if trans:
                    tile = tile.reshape(4, 8, d)[:, perm].reshape(32, d).T
                rows, cols = tile.shape
                big = _read_panel(im[2 * i * half:(2 * i + 1) * half], rows,
                                  cols)
                small = _read_panel(im[(2 * i + 1) * half:(2 * i + 2) * half],
                                    rows, cols)
                assert np.array_equal(big, _tf32(tile))
                assert (np.abs(big.astype(np.float64) + small - tile)
                        <= 2.0**-21 * np.abs(tile)).all()
            if kind == 1:
                rows = im[8 * half:]
                for j, x in enumerate((lse, delta)):
                    want = _rows_of(x.reshape(2, n)[bh], 32 * t, 32)
                    assert np.array_equal(rows[32 * j:32 * (j + 1)], want)
                assert not rows[64:].any()
    # zero rows past n: the last tile's rows 70 - 64 = 6 .. 31
    assert not _read_panel(img[0, 2, :half], 32, d)[6:].any()


def test_fragment_operand_is_a_permutation_of_the_sums():
    """sums_fragment hands every one of the 64 x 32 sums to exactly one
    A-operand element, keeping its row and moving column 8 j + 2 t + e to k
    = 8 j + t + 4 e: the image's row order inside each group of 8."""
    sums = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
    a = _fragment_operand(sums)
    assert not np.isnan(a).any()
    perm = np.array([0, 2, 4, 6, 1, 3, 5, 7])
    cols = (np.arange(32) // 8 * 8 + perm[np.arange(32) % 8])
    assert np.array_equal(a, sums[:, cols])
    assert np.array_equal(tattn._PERM8.numpy(), perm)
