"""
The port's conv ops against the JAX package's, on the CPU.

The same numpy inputs go through both sides. ``conv3d_igemm`` on a CPU
tensor runs its plain version (the CUDA kernel is compared with that
plain version on the card by ``chip_smoke.py``). Tolerance 1e-4 abs on
unit-scale f32 data: both sides sum the same products in f32, in
different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import adell_mri_tpu.ops.pallas.conv as pconv_mod
from adell_mri_tpu.ops.conv import (
    TpuConv,
    TpuConvTranspose,
    conv3d_im2col_trainable,
    conv3d_xla,
)
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.ops import conv as tconv
from adell_mri_torch.ops.kernels import conv as kconv

TOL = 1e-4


def _inputs(seed, x_shape, cout):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=x_shape).astype(np.float32)
    w = (
        rng.normal(size=(3, 3, 3, x_shape[-1], cout))
        / np.sqrt(27 * x_shape[-1])
    ).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    return x, w, b


def test_igemm_reference_matches_pallas_interpret():
    x, w, _ = _inputs(1, (1, 3, 128, 8, 4), 8)
    real = pconv_mod.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return real(*args, **kwargs)

    pconv_mod.pl.pallas_call = patched
    try:
        want = np.asarray(
            pconv_mod.conv3d_pallas_raw(jnp.asarray(x), jnp.asarray(w))
        )
    finally:
        pconv_mod.pl.pallas_call = real
    got = kconv.conv3d_igemm_reference(
        torch.from_numpy(x), torch.from_numpy(w)
    ).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < TOL


@pytest.mark.parametrize(
    "x_shape,cout",
    [
        ((2, 5, 6, 7, 3), 5),
        ((1, 4, 6, 5, 1), 1),
        ((2, 3, 4, 5, 1), 6),
        ((1, 6, 5, 4, 17), 3),
    ],
)
def test_igemm_reference_matches_conv3d_xla(x_shape, cout):
    x, w, b = _inputs(2, x_shape, cout)
    want = np.asarray(conv3d_xla(jnp.asarray(x), jnp.asarray(w))) + b
    got = kconv.conv3d_igemm_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    ).numpy()
    assert np.abs(got - want).max() < TOL


def test_igemm_wrapper_takes_plain_path_on_cpu():
    x, w, b = _inputs(3, (1, 4, 5, 6, 3), 4)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    before = kconv.conv3d_igemm.launches
    got = kconv.conv3d_igemm(xt, wt, bt)
    assert kconv.conv3d_igemm.launches == before  # no kernel launched
    torch.testing.assert_close(
        got, kconv.conv3d_igemm_reference(xt, wt, bt), rtol=0, atol=0
    )
    # bf16 in, bf16 out, f32 accumulation inside
    got16 = kconv.conv3d_igemm(xt.bfloat16(), wt.bfloat16(), bt.bfloat16())
    assert got16.dtype == torch.bfloat16
    assert (got16.float() - got).abs().max() < 0.1


def _grads(fn, x, w, b, g):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    return torch.autograd.grad(fn(*leaves), leaves, torch.from_numpy(g))


@pytest.mark.parametrize(
    "x_shape,cout", [((2, 5, 6, 4, 3), 4), ((1, 4, 3, 5, 1), 6)]
)
def test_igemm_gradient_matches_autograd_and_jax(x_shape, cout):
    """The Function's dx (the plain version on the flipped, channel-swapped
    weight), dW (patch product) and dbias against autograd through
    ``F.conv3d`` and against the JAX package's hand-written conv VJP."""
    x, w, b = _inputs(7, x_shape, cout)
    g = np.random.default_rng(8).normal(
        size=x_shape[:4] + (cout,)).astype(np.float32)
    got = _grads(kconv.conv3d_igemm_train, x, w, b, g)
    want = _grads(kconv.conv3d_igemm_reference, x, w, b, g)
    _, vjp = jax.vjp(
        lambda xx, ww: conv3d_im2col_trainable(xx, ww, (1, 1, 1), "SAME"),
        jnp.asarray(x), jnp.asarray(w),
    )
    jdx, jdw = vjp(jnp.asarray(g))
    for name, t, r in zip(("dx", "dw", "db"), got, want):
        scale = float(r.abs().max())
        # f32 sums of the same products in different orders
        assert float((t - r).abs().max()) <= 1e-5 * scale, name
    for t, j in ((got[0], jdx), (got[1], jdw)):
        scale = float(np.abs(np.asarray(j)).max())
        assert float(np.abs(t.numpy() - np.asarray(j)).max()) <= (
            1e-5 * scale)


def test_igemm_gradient_skips_dx_of_a_leaf_input():
    x, w, b = _inputs(9, (1, 4, 4, 4, 2), 3)
    wt = torch.from_numpy(w).requires_grad_()
    y = kconv.conv3d_igemm_train(torch.from_numpy(x), wt, torch.from_numpy(b))
    (dw,) = torch.autograd.grad(y.sum(), [wt])
    assert dw.shape == wt.shape
    # without a gradient to take, no Function is recorded
    with torch.no_grad():
        y = kconv.conv3d_igemm_train(torch.from_numpy(x), wt)
    assert y.grad_fn is None


@pytest.mark.parametrize("reduced", [True, False])
def test_weight_grad_sums_bf16_in_f32(monkeypatch, reduced):
    """dW's product runs with cuBLAS's bf16 reduced-precision reduction off
    (f32 sums, rounded once) and gives the caller's setting back."""
    matmul = torch.backends.cuda.matmul
    seen = []
    real = torch.matmul

    def spy(*args):
        seen.append(matmul.allow_bf16_reduced_precision_reduction)
        return real(*args)

    monkeypatch.setattr(matmul, "allow_bf16_reduced_precision_reduction",
                        reduced)
    monkeypatch.setattr(torch, "matmul", spy)
    x, _, _ = _inputs(10, (1, 4, 4, 4, 2), 3)
    g = torch.ones((1, 4, 4, 4, 3), dtype=torch.bfloat16)
    dw = kconv.conv3d_weight_grad(torch.from_numpy(x).bfloat16(), g)
    assert dw.shape == (3, 3, 3, 2, 3)
    assert seen == [False]
    assert matmul.allow_bf16_reduced_precision_reduction is reduced


def test_igemm_wrapper_rejects_bad_inputs():
    x = torch.zeros(1, 4, 4, 4, 3)
    with pytest.raises(ValueError):
        kconv._check(x, torch.zeros(3, 3, 3, 2, 4), None)
    with pytest.raises(TypeError):
        kconv._check(x, torch.zeros(3, 3, 3, 3, 4, dtype=torch.bfloat16), None)
    with pytest.raises(ValueError):
        kconv._check(x.transpose(1, 2), torch.zeros(3, 3, 3, 3, 4), None)
    with pytest.raises(ValueError):
        kconv._check(x, torch.zeros(3, 3, 3, 3, 4), torch.zeros(5))


def _flax_params(module, x):
    variables = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(4)
    return jax.tree.map(
        lambda s: jnp.asarray(rng.normal(size=s.shape).astype(np.float32)),
        variables["params"],
    )


@pytest.mark.parametrize("strides", [(2, 2, 2), (2, 2, 1)])
def test_strided_conv_matches_tpu_conv(strides):
    """Downsample convs pad symmetrically by k//2 (unet.py:100-109)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 6, 5, 3)).astype(np.float32)
    pad = ((1, 1),) * 3
    jm = TpuConv(4, (3, 3, 3), strides=strides, padding=pad)
    params = _flax_params(jm, jnp.asarray(x))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = tconv.Conv3d(3, 4, (3, 3, 3), strides=strides, padding=pad)
    tm.load_state_dict(from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < TOL


@pytest.mark.parametrize("kernel", [(2, 2, 2), (2, 2, 1)])
def test_transposed_conv_matches_tpu_conv_transpose(kernel):
    """flax applies the transposed kernel spatially flipped; the converter
    flips it once, so the port applies it as stored."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 3, 4, 2, 5)).astype(np.float32)
    jm = TpuConvTranspose(3, kernel)
    params = {"up_0": _flax_params(jm, jnp.asarray(x))}
    want = np.asarray(jm.apply({"params": params["up_0"]}, jnp.asarray(x)))
    tm = tconv.ConvTranspose3d(5, 3, kernel)
    state = {
        k.split(".", 1)[1]: v
        for k, v in from_flax(jax.tree.map(np.asarray, params)).items()
    }
    tm.load_state_dict(state)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < TOL


@pytest.mark.parametrize(
    "module,fan_in",
    [
        (lambda: tconv.Conv3d(16, 8, (3, 3, 3)), 16 * 27),
        (lambda: tconv.ConvTranspose3d(32, 8, (2, 2, 2)), 32 * 8),
        (lambda: tconv.Pointwise(64, 40), 64),
    ],
)
def test_initialisers_match_flax_lecun_normal(module, fan_in):
    """The port draws its kernels as the JAX package does: a normal
    truncated at two standard deviations with variance 1/fan_in."""
    torch.manual_seed(0)
    w = module().weight.detach().numpy().ravel()
    ref = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (fan_in, 4000))).ravel()
    # sample std of a few thousand draws: within 5 % of each other
    assert abs(w.std() - ref.std()) < 0.05 * ref.std()
    bound = 2 * fan_in**-0.5 / 0.87962566103423978
    assert np.abs(w).max() <= bound + 1e-6
    assert np.abs(ref).max() <= bound + 1e-6


# -- the Hopper route: routing, boxes and the box/halo/tap decomposition ----

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cin", [1, 3, 8, 16, 48, 64, 256])
@pytest.mark.parametrize("cout", [1, 3, 16, 24, 128, 256])
def test_conv_route(dtype, cin, cout):
    """Either dtype with one side of at most 4 channels and the other of at
    most 64 takes the narrow kernel (the stems, the Cout = 1 dx); of the
    rest, bf16 with Cin a multiple of 16 and Cout of 8 takes the wgmma
    kernel, f32 with Cin and Cout multiples of 8 the 3xTF32 kernel, and the
    others (bf16 Cin 8, Cin 1 with Cout 128, Cout 3 beside a wide Cin) the
    igemm kernel."""
    if min(cin, cout) <= 4 and max(cin, cout) <= 64:
        want = "narrow"
    elif dtype == torch.bfloat16 and cin % 16 == 0 and cout % 8 == 0:
        want = "wgmma"
    elif dtype == torch.float32 and cin % 8 == 0 and cout % 8 == 0:
        want = "tf32"
    else:
        want = "igemm"
    assert kconv.conv_route(dtype, cin, cout) == want


@pytest.mark.parametrize("cin,cout,want", [
    (8, 8, "tf32"), (16, 16, "tf32"), (32, 32, "tf32"), (256, 256, "tf32"),
    (1, 32, "narrow"), (32, 1, "narrow"), (3, 32, "narrow"),
    (12, 16, "igemm"), (8, 12, "igemm"),
])
def test_conv_route_f32_classes(cin, cout, want):
    """f32, the CLI's default precision: every conv of the flagship's main
    paths that is not narrow takes the 3xTF32 kernel; widths that are not
    multiples of 8 stay on the igemm kernel; bf16 routes as before."""
    assert kconv.conv_route(torch.float32, cin, cout) == want
    bf16 = {(8, 8): "igemm", (16, 16): "wgmma", (32, 32): "wgmma",
            (256, 256): "wgmma", (12, 16): "igemm", (8, 12): "igemm"}
    assert kconv.conv_route(torch.bfloat16, cin, cout) == bf16.get(
        (cin, cout), "narrow")


def _box_cover(d, h, w, box):
    """How often each output voxel falls in a box of the grid."""
    tz, ty, tx = box
    counts = np.zeros((d, h, w), dtype=np.int64)
    for z0 in range(0, d, tz):
        for y0 in range(0, h, ty):
            for x0 in range(0, w, tx):
                counts[z0:z0 + tz, y0:y0 + ty, x0:x0 + tx] += 1
    return counts


#: output voxels of the shipped build's box (two warpgroups of 64)
BOX = 128


def _halo_limit(cin, cout, stages=4, work=2048):
    """The most halo rows of the shipped build (``Plan`` in
    ``csrc/conv3d_igemm.cu``), worked out in Python: a channel chunk of the
    largest of 64, 32, 16 dividing Cin, an N block of Cout padded to 16, 32,
    64 or 128, G taps a ring stage (products G * ck * nb reach ``work``; the
    ring's lead of ``stages - 2`` steps caps G at 9), ``stages`` stages
    rounded to 1024 bytes, 1024 bytes of alignment, and two halo buffers of
    rows of 2 ck + 16 bytes when Cin has several chunks. The card tests hold
    ``adell_conv3d_wgmma_limits`` to it."""
    ck = next(c for c in (64, 32, 16) if cin % c == 0)
    nb = next(n for n in (16, 32, 64, 128) if n >= min(cout, 128))
    g = next(g for g in (1, 3, 9) if g * ck * nb >= work or g == 9)
    stage = -(-g * ck * nb * 2 // 1024) * 1024
    bufs = 2 if cin > ck else 1
    room = (232448 - stages * stage - 1024) // bufs // 128 * 128
    return room // (2 * ck + 16)


class _Limits:
    """Stands in for the library: ``adell_conv3d_wgmma_limits`` answers
    (voxels, halo rows) for Cin and Cout multiples of 16 and 8 (by default
    those of the shipped build), and counts its calls."""

    def __init__(self, voxels=BOX, rows=None):
        self.voxels, self.rows, self.calls = voxels, rows, 0

    def adell_conv3d_wgmma_limits(self, cin, cout, out):
        self.calls += 1
        if cin % 16 or cout % 8:
            return 1
        out[0] = self.voxels
        out[1] = _halo_limit(cin, cout) if self.rows is None else self.rows
        return 0


def _check_plan(b, d, h, w, cin, cout):
    """The box of a launch covers every output voxel once, has the build's
    voxel count and a halo within the shared memory left beside the ring."""
    box = kconv.wgmma_box(_Limits(), d, h, w, cin, cout)
    tz, ty, tx = box
    assert tz * ty * tx == BOX
    assert (_box_cover(d, h, w, box) == 1).all()
    assert (tz + 2) * (ty + 2) * (tx + 2) <= _halo_limit(cin, cout)
    return box


# the main paths' shapes (U-Net levels at B=4, UNETR levels at B=1, their
# dx with Cin and Cout swapped) and ragged volumes
PLAN_SHAPES = [
    (4, 128, 128, 32, 32, 32), (4, 128, 128, 32, 64, 32),
    (4, 64, 64, 16, 64, 64), (4, 32, 32, 8, 128, 64),
    (4, 16, 16, 4, 256, 256), (4, 16, 16, 4, 128, 256),
    (4, 8, 8, 2, 128, 256), (4, 8, 8, 2, 256, 128),
    (1, 256, 256, 64, 32, 16), (1, 256, 256, 64, 16, 32),
    (1, 32, 32, 8, 256, 128), (1, 7, 9, 5, 16, 16), (1, 7, 9, 5, 48, 24),
    (2, 3, 5, 7, 16, 8), (1, 1, 1, 1, 64, 64),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_wgmma_plan_covers_every_voxel_once(shape):
    _check_plan(*shape)


@pytest.mark.parametrize(
    "spatial,box",
    [((128, 128, 32), (4, 4, 8)), ((64, 64, 16), (4, 4, 8)),
     ((16, 16, 4), (4, 8, 4)), ((8, 8, 2), (8, 8, 2)),
     ((256, 256, 64), (4, 4, 8))],
)
def test_plan_box_picks_the_smallest_halo(spatial, box):
    """No ragged box at the main paths' levels, and the halo of 360 rows of
    a near-cubic box (400 at 8x8x2, whose whole level is one box)."""
    assert kconv.plan_box(*spatial, BOX) == box


def test_wgmma_smem_by_hand():
    """Halo limits worked out by hand: 256->256 has four chunks of 64 and
    four 16 KB stages of one tap, so two buffers of 144-byte rows share
    232448 - 1024 - 65536 bytes (576 rows, the tightest of the build);
    32->32 one buffer of 80-byte rows beside four 6 KB stages of three taps;
    48->24 three chunks of 16 (48-byte rows) beside four 9 KB stages of nine
    taps, as many as the ring's lead allows."""
    assert _halo_limit(256, 256) == 82944 // 144 == 576
    assert _halo_limit(32, 32) == (232448 - 4 * 6144 - 1024) // 80 == 2585
    assert _halo_limit(48, 24) == (232448 - 4 * 9216 - 1024) // 2 // 48
    assert _halo_limit(16, 16) == _halo_limit(16, 16, work=8192)


def test_wgmma_box_asks_the_launcher_once_a_shape():
    """The box follows the launcher's limits, and a launch at a shape seen
    before costs a cache lookup, not a plan."""
    lib = _Limits(BOX, 360)
    assert kconv.wgmma_box(lib, 128, 128, 32, 32, 32) == (4, 4, 8)
    assert kconv.wgmma_box(lib, 128, 128, 32, 32, 32) == (4, 4, 8)
    assert lib.calls == 1
    assert kconv.wgmma_box(_Limits(64, 1000), 16, 16, 4, 64, 64) == (
        4, 4, 4)
    # no box of 128 voxels has a halo under 360 rows; Cin 8 has no kernel
    with pytest.raises(ValueError):
        kconv.wgmma_box(_Limits(BOX, 300), 64, 64, 16, 16, 16)
    with pytest.raises(ValueError):
        kconv.wgmma_box(lib, 8, 8, 8, 8, 16)


def test_plan_box_respects_a_halo_cap():
    assert kconv.plan_box(7, 9, 5, BOX, max_halo_rows=360) in (
        (4, 4, 8), (4, 8, 4), (8, 4, 4))
    with pytest.raises(ValueError):
        kconv.plan_box(8, 8, 8, BOX, max_halo_rows=100)
    with pytest.raises(ValueError):
        kconv.plan_box(8, 8, 8, 96)


@settings(max_examples=40, deadline=None)
@given(
    d=st.integers(1, 40), h=st.integers(1, 40), w=st.integers(1, 40),
    cin=st.sampled_from([16, 32, 48, 64, 96, 128, 256]),
    cout=st.integers(1, 32).map(lambda n: 8 * n),
)
def test_wgmma_plan_property(d, h, w, cin, cout):
    _check_plan(1, d, h, w, cin, cout)


def emulate_wgmma_conv(x, w, bias):
    """The wgmma kernel's decomposition in numpy (f32): for each box of
    ``wgmma_box`` and each channel chunk, the halo (zeros outside the
    volume) is cut once, and each of the 27 taps multiplies the halo rows shifted by the
    tap with that tap's weight rows; ragged boxes are computed and cropped."""
    b, d, h, wd, cin = x.shape
    cout = w.shape[-1]
    tz, ty, tx = kconv.wgmma_box(_Limits(), d, h, wd, cin, cout)
    # the launcher's channel chunk: the largest of 64, 32, 16 dividing Cin
    ck = next(c for c in (64, 32, 16) if cin % c == 0)
    nz, ny, nx = -(-d // tz), -(-h // ty), -(-wd // tx)
    xp = np.zeros((b, nz * tz + 2, ny * ty + 2, nx * tx + 2, cin), np.float32)
    xp[:, 1:d + 1, 1:h + 1, 1:wd + 1] = x
    out = np.zeros((b, nz * tz, ny * ty, nx * tx, cout), np.float32)
    for bi in range(b):
        for z0 in range(0, nz * tz, tz):
            for y0 in range(0, ny * ty, ty):
                for x0 in range(0, nx * tx, tx):
                    acc = np.zeros((tz * ty * tx, cout), np.float32)
                    for c0 in range(0, cin, ck):
                        halo = xp[bi, z0:z0 + tz + 2, y0:y0 + ty + 2,
                                  x0:x0 + tx + 2, c0:c0 + ck]
                        for t in range(27):
                            dz, dy, dx = t // 9, t // 3 % 3, t % 3
                            rows = halo[dz:dz + tz, dy:dy + ty, dx:dx + tx]
                            acc += rows.reshape(-1, ck) @ w[dz, dy, dx,
                                                            c0:c0 + ck]
                    out[bi, z0:z0 + tz, y0:y0 + ty, x0:x0 + tx] = (
                        acc.reshape(tz, ty, tx, cout))
    return out[:, :d, :h, :wd] + bias


@pytest.mark.parametrize("x_shape,cout", [((2, 7, 9, 5, 48), 24),
                                          ((1, 5, 6, 10, 32), 16)])
def test_box_halo_emulation_matches_reference_and_jax(x_shape, cout):
    x, w, b = _inputs(11, x_shape, cout)
    got = emulate_wgmma_conv(x, w, b)
    want = kconv.conv3d_igemm_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    ).numpy()
    jax_want = np.asarray(conv3d_xla(jnp.asarray(x), jnp.asarray(w))) + b
    # f32 sums of the same products in different orders
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(got - jax_want).max() <= 1e-5 * np.abs(jax_want).max()


def test_wgmma_route_counts_nothing_on_the_cpu():
    x, w, b = _inputs(12, (1, 4, 4, 8, 16), 16)
    xt, wt, bt = (torch.from_numpy(a).bfloat16() for a in (x, w, b))
    before = (kconv.conv3d_igemm.wgmma_launches,
              kconv.conv3d_igemm_dx.wgmma_launches)
    y = kconv.conv3d_igemm_train(xt.requires_grad_(), wt, bt)
    y.float().sum().backward()
    assert (kconv.conv3d_igemm.wgmma_launches,
            kconv.conv3d_igemm_dx.wgmma_launches) == before


# -- the 3xTF32 route: rounding, weight, fragments and decomposition -------

def _tf32_np(a):
    """``cvt.rna.tf32.f32`` in numpy: half a TF32 ulp added to the
    magnitude's bits, the low 13 bits cleared."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def test_tf32_round_is_round_to_nearest_ties_away():
    """``tf32_round`` keeps 11 significant bits, rounding to nearest with
    ties away from zero (so a tie of either sign grows in magnitude), with
    a carry into the exponent, and leaves TF32 values as they are."""
    one = 1.0
    ulp = 2.0**-10  # TF32's ulp at 1
    vals = np.array([
        one, -one, one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2**-23,
        one + 3 * ulp / 2, 2 - ulp / 2, 3.0e-39, 0.0, -0.0, 1e30,
        np.float32(np.pi), -np.float32(np.e),
    ], np.float32)
    want = np.array([
        one, -one, one + ulp, -(one + ulp), one, one + 2 * ulp, 2.0,
        _tf32_np(np.array([3.0e-39], np.float32))[0], 0.0, -0.0,
        _tf32_np(np.array([1e30], np.float32))[0],
        np.float32(3.140625), -np.float32(2.71875),
    ], np.float32)
    got = kconv.tf32_round(torch.from_numpy(vals)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    rng = np.random.default_rng(20)
    r = (rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, 4096)
         ).astype(np.float32)
    got = kconv.tf32_round(torch.from_numpy(r)).numpy()
    assert np.array_equal(got, _tf32_np(r))
    assert not (got.view(np.uint32) & 0x1FFF).any()
    # within half a TF32 ulp: 2^-11 of the magnitude
    assert (np.abs(got - r) <= 2.0**-11 * np.abs(r)).all()
    assert np.array_equal(kconv.tf32_round(torch.from_numpy(got)).numpy(),
                          got)


@pytest.mark.parametrize("cin,cout", [(16, 16), (8, 24), (32, 256),
                                      (48, 40)])
def test_tf32_split_weight_layout_and_sum(cin, cout):
    """The prepared weight is [2, 27, Cout_pad, Cin], K-major (row co of tap
    t is w[t, :, co]); big and small are TF32 values whose sum is w within
    2^-21 of its magnitude; rows past Cout are zero. For dx the wrapper
    prepares the flipped, channel-swapped weight, whose rows are the input
    channels of w in reversed tap order."""
    _, w, _ = _inputs(21, (1, 2, 2, 2, cin), cout)
    cout_pad = kconv.tf32_plan(cin, cout).cout_pad
    assert cout_pad % 16 == 0 and cout <= cout_pad < cout + 64
    wk = kconv.tf32_split_weight(torch.from_numpy(w), cout_pad).numpy()
    assert wk.shape == (2, 27, cout_pad, cin)
    big, small = wk[:, :, :cout]
    want = w.reshape(27, cin, cout).transpose(0, 2, 1)
    assert not (wk.view(np.uint32) & 0x1FFF).any()
    assert np.array_equal(big, _tf32_np(want))
    assert (np.abs(big.astype(np.float64) + small - want)
            <= 2.0**-21 * np.abs(want)).all()
    assert not wk[:, :, cout:].any()
    # dx: [27, Cin_pad, Cout] rows are w's input channels, taps reversed
    w_rot = torch.from_numpy(w).flip(0, 1, 2).transpose(3, 4).contiguous()
    cin_pad = kconv.tf32_plan(cout, cin).cout_pad
    dk = kconv.tf32_split_weight(w_rot, cin_pad).numpy()
    assert dk.shape == (2, 27, cin_pad, cout)
    assert np.array_equal(dk[0, :, :cin], _tf32_np(w.reshape(27, cin, cout)
                                                   [::-1]))


def test_same_conv_weights_prepares_each_weight_once():
    """Inside a ``same_conv_weights`` block the 3xTF32 route prepares a
    weight once and hands the same tensor to every launch that uses it,
    with ``tf32_split_weight``'s bits; a block opened inside shares it;
    outside any block, and after the outermost one ends, each launch
    prepares its own."""
    _, w1, _ = _inputs(22, (1, 2, 2, 2, 16), 24)
    _, w2, _ = _inputs(23, (1, 2, 2, 2, 16), 24)
    w1, w2 = torch.from_numpy(w1), torch.from_numpy(w2)
    want1 = kconv.tf32_split_weight(w1, 32)
    assert kconv._tf32_weight(w1, 32) is not kconv._tf32_weight(w1, 32)
    with kconv.same_conv_weights():
        first = kconv._tf32_weight(w1, 32)
        assert torch.equal(first, want1)
        assert kconv._tf32_weight(w1, 32) is first
        with kconv.same_conv_weights():
            assert kconv._tf32_weight(w1, 32) is first
            other = kconv._tf32_weight(w2, 32)
        assert kconv._tf32_weight(w2, 32) is other
        assert torch.equal(other, kconv.tf32_split_weight(w2, 32))
    assert kconv._tf32_weights is None
    assert kconv._tf32_weight(w1, 32) is not first


def test_sliding_window_opens_same_conv_weights():
    """The sliding window runs its micro-batches inside one
    ``same_conv_weights`` block, and closes it when done."""
    from adell_mri_torch.inference.sliding_window import (
        sliding_window_inference,
    )

    seen = []

    def fn(batch):
        seen.append(kconv._tf32_weights is not None)
        return batch

    vol = torch.zeros((8, 8, 4, 1))
    sliding_window_inference(fn, vol, (4, 4, 4), 0.5, batch_size=2)
    assert len(seen) > 1 and all(seen)
    assert kconv._tf32_weights is None


def test_ldmatrix_gives_the_tf32_a_fragment():
    """The kernel's A operand: ``ldmatrix.x4`` (b16, not transposed) with
    lane l naming row (l % 8) + 8 ((l / 8) % 2) of the warp's 16 and the
    16-byte half l / 16 of a k-step's 32 bytes, as the bf16 kernel does.
    Read as f32, what lane l gets in register i is element (l / 4 + 8 (i %
    2), l % 4 + 4 (i / 2)) of the 16 x 8 step, which is wgmma m64nNk8's
    TF32 A fragment (the PTX ISA's figure for .tf32 A in registers)."""
    step = np.arange(16 * 8, dtype=np.float32).reshape(16, 8) + 0.5
    rows = step.view(np.uint16).reshape(16, 16)  # each row: 16 b16 values
    for lane in range(32):
        for i in range(4):
            # matrix i takes its 8 row addresses from lanes 8i .. 8i + 7
            src = 8 * i + lane // 4
            row, half = src % 8 + 8 * (src // 8 % 2), src // 16
            b16 = rows[row, 8 * half + 2 * (lane % 4):][:2]
            got = b16.view(np.float32)[0]
            assert got == step[lane // 4 + 8 * (i % 2), lane % 4 + 4 * (i // 2)]


def _tf32_limits_lib():
    """Stands in for the library's ``adell_conv3d_wgmma_tf32x3_limits``,
    answering with the Python mirror of the shipped build."""

    class Lib:
        calls = 0

        def adell_conv3d_wgmma_tf32x3_limits(self, cin, cout, out):
            Lib.calls += 1
            plan = kconv.tf32_plan(cin, cout)
            out[0], out[1], out[2] = (plan.voxels, plan.max_halo_rows,
                                      plan.cout_pad)
            return 0

    return Lib()


def emulate_tf32x3_conv(x, w, bias, passes=3):
    """The 3xTF32 kernel's arithmetic in numpy: the weight as the wrapper
    prepares it (``tf32_split_weight``); for each box of ``plan_box`` within
    the kernel's limits and each channel chunk, the halo (zeros outside the
    volume) is cut once; each of the 27 taps takes the halo rows shifted by
    the tap, 8 channels (a k-step) at a time, splits them into TF32 big and
    small parts (``cvt.rna``) and adds small * big, big * small and big *
    big (f32 sums); ``passes=1`` is one TF32 product, big * big. Ragged
    boxes are computed and cropped."""
    b, d, h, wd, cin = x.shape
    cout = w.shape[-1]
    plan = kconv.tf32_plan(cin, cout)
    voxels, rows, cout_pad = kconv.tf32_limits(_tf32_limits_lib(), cin, cout)
    tz, ty, tx = kconv.plan_box(d, h, wd, voxels, rows)
    wk = kconv.tf32_split_weight(torch.from_numpy(w), cout_pad).numpy()
    ck = plan.ck
    nz, ny, nx = -(-d // tz), -(-h // ty), -(-wd // tx)
    xp = np.zeros((b, nz * tz + 2, ny * ty + 2, nx * tx + 2, cin), np.float32)
    xp[:, 1:d + 1, 1:h + 1, 1:wd + 1] = x
    out = np.zeros((b, nz * tz, ny * ty, nx * tx, cout_pad), np.float32)
    for bi in range(b):
        for z0 in range(0, nz * tz, tz):
            for y0 in range(0, ny * ty, ty):
                for x0 in range(0, nx * tx, tx):
                    acc = np.zeros((tz * ty * tx, cout_pad), np.float32)
                    for c0 in range(0, cin, ck):
                        halo = xp[bi, z0:z0 + tz + 2, y0:y0 + ty + 2,
                                  x0:x0 + tx + 2, c0:c0 + ck]
                        for t in range(27):
                            dz, dy, dx = t // 9, t // 3 % 3, t % 3
                            a = halo[dz:dz + tz, dy:dy + ty,
                                     dx:dx + tx].reshape(-1, ck)
                            for k0 in range(c0, c0 + ck, 8):
                                a8 = a[:, k0 - c0:k0 - c0 + 8]
                                a_big = _tf32_np(a8)
                                a_small = _tf32_np(a8 - a_big)
                                b_big = wk[0, t, :, k0:k0 + 8].T
                                b_small = wk[1, t, :, k0:k0 + 8].T
                                if passes == 3:
                                    acc += a_small @ b_big
                                    acc += a_big @ b_small
                                acc += a_big @ b_big
                    out[bi, z0:z0 + tz, y0:y0 + ty, x0:x0 + tx] = (
                        acc.reshape(tz, ty, tx, cout_pad))
    return out[:, :d, :h, :wd, :cout] + bias


def _pallas_interpret_conv(x, w):
    """The TPU kernel (``_kernel``) run in interpret mode on the CPU, f32
    at the test session's pinned matmul precision."""
    real = pconv_mod.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return real(*args, **kwargs)

    pconv_mod.pl.pallas_call = patched
    try:
        got = pconv_mod.conv3d_pallas_raw(jnp.asarray(x), jnp.asarray(w))
    finally:
        pconv_mod.pl.pallas_call = real
    assert got is not None, "the TPU kernel does not take this shape"
    return np.asarray(got)


#: (x shape, Cout): ragged volumes with one chunk of 16 and three chunks of
#: 8 beside an N block padded from 24 to 32 (the JAX conv: XLA's, which the
#: TPU kernel's gate leaves them to), and a shape the TPU kernel takes (a
#: 128-wide axis), run through it in interpret mode
TF32_SHAPES = [((1, 7, 9, 5, 16), 16), ((2, 3, 5, 7, 8), 24),
               ((1, 3, 128, 8, 8), 16)]


def _tf32_case(x_shape, cout):
    x, w, b = _inputs(22, x_shape, cout)
    want = kconv.conv3d_igemm_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    ).numpy()
    if x_shape[2] % 128 == 0:
        jax_want = _pallas_interpret_conv(x, w) + b
    else:
        jax_want = np.asarray(conv3d_xla(jnp.asarray(x), jnp.asarray(w))) + b
    return x, w, b, want, jax_want


@pytest.mark.parametrize("x_shape,cout", TF32_SHAPES, ids=str)
def test_tf32x3_emulation_matches_reference_and_jax(x_shape, cout):
    """Three TF32 products keep f32's accuracy: within 1e-5 of the output
    scale of the plain version and of the JAX conv (f32 sums of nearly the
    same products in other orders)."""
    x, w, b, want, jax_want = _tf32_case(x_shape, cout)
    got = emulate_tf32x3_conv(x, w, b)
    for ref in (want, jax_want):
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("x_shape,cout", TF32_SHAPES, ids=str)
def test_one_tf32_pass_fails_the_bound(x_shape, cout):
    """The check tells the two apart: one TF32 product (what cuDNN's f32
    conv does by default) misses 1e-5 of the scale by an order of
    magnitude and more."""
    x, w, b, want, jax_want = _tf32_case(x_shape, cout)
    got = emulate_tf32x3_conv(x, w, b, passes=1)
    for ref in (want, jax_want):
        assert np.abs(got - ref).max() > 1e-5 * np.abs(ref).max()


def test_tf32x3_emulation_of_dx_matches_plain():
    """dx is the same kernel on the cotangent and the flipped,
    channel-swapped weight (24 -> 8 here: three chunks of 8)."""
    x, w, _ = _inputs(23, (2, 3, 5, 7, 8), 24)
    g = np.random.default_rng(24).normal(size=(2, 3, 5, 7, 24)).astype(
        np.float32)
    w_rot = np.ascontiguousarray(w[::-1, ::-1, ::-1].transpose(0, 1, 2, 4, 3))
    got = emulate_tf32x3_conv(g, w_rot, np.zeros(8, np.float32))
    want = kconv.conv3d_igemm_dx(torch.from_numpy(g),
                                 torch.from_numpy(w)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_tf32_plan_by_hand():
    """The shipped build's layout, worked out by hand: 32->32 has one chunk
    of 32 (144-byte halo rows) and four 8 KB stages of one tap (big and
    small slabs of 32 rows of 128 bytes); 256->256 eight chunks, four N
    blocks of 64 and four 16 KB stages of one tap beside two halo buffers;
    32->16 one tap a stage too; 16->16 and 8->24 three; 8->8 nine, as many
    as the ring's lead allows; 8->24 three chunks of 8 (48-byte rows) and
    Cout padded to 32."""
    assert kconv.tf32_plan(32, 32) == (32, 32, 32, 1, 4, 128,
                                       (232448 - 4 * 8192 - 1024) // 144)
    assert kconv.tf32_plan(256, 256) == (32, 64, 256, 1, 4, 128,
                                         (232448 - 4 * 16384 - 1024)
                                         // 2 // 128 * 128 // 144)
    assert kconv.tf32_plan(256, 256).max_halo_rows == 576
    assert kconv.tf32_plan(32, 16)[:5] == (32, 16, 16, 1, 4)
    assert kconv.tf32_plan(16, 16)[:5] == (16, 16, 16, 3, 4)
    assert kconv.tf32_plan(8, 8)[:5] == (8, 16, 16, 9, 4)
    assert kconv.tf32_plan(8, 24)[:5] == (8, 32, 32, 3, 4)
    for cin, cout in ((4, 32), (12, 16), (8, 12)):
        with pytest.raises(ValueError):
            kconv.tf32_plan(cin, cout)


@settings(max_examples=40, deadline=None)
@given(
    d=st.integers(1, 40), h=st.integers(1, 40), w=st.integers(1, 40),
    cin=st.integers(1, 32).map(lambda n: 8 * n),
    cout=st.integers(1, 32).map(lambda n: 8 * n),
)
def test_tf32_plan_property(d, h, w, cin, cout):
    """Every f32 class of the route has a box of the build's voxels whose
    halo fits its limit and whose grid covers every output voxel once, and
    its ring and halo buffers fit a block's shared memory."""
    plan = kconv.tf32_plan(cin, cout)
    box = kconv.plan_box(d, h, w, plan.voxels, plan.max_halo_rows)
    tz, ty, tx = box
    assert tz * ty * tx == plan.voxels
    assert (_box_cover(d, h, w, box) == 1).all()
    assert plan.max_halo_rows >= 360
    stage = -(-plan.g * 2 * plan.nb * plan.ck * 4 // 1024) * 1024
    bufs = 2 if cin > plan.ck else 1
    halo = -(-(tz + 2) * (ty + 2) * (tx + 2) * (4 * plan.ck + 16) // 128) * 128
    assert plan.stages * stage + bufs * halo + 1024 <= 232448
    assert 27 // plan.g >= plan.stages - 2


def test_tf32_route_counts_nothing_on_the_cpu():
    """On CPU tensors the f32 classes of the route take the plain version,
    forward and dx, and count no launch."""
    x, w, b = _inputs(25, (1, 4, 4, 8, 16), 16)
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    before = (kconv.conv3d_igemm.tf32_launches,
              kconv.conv3d_igemm_dx.tf32_launches,
              kconv.conv3d_igemm.launches, kconv.conv3d_igemm_dx.launches)
    y = kconv.conv3d_igemm_train(xt.requires_grad_(), wt, bt)
    y.sum().backward()
    assert (kconv.conv3d_igemm.tf32_launches,
            kconv.conv3d_igemm_dx.tf32_launches,
            kconv.conv3d_igemm.launches,
            kconv.conv3d_igemm_dx.launches) == before
    assert torch.equal(y, kconv.conv3d_igemm_reference(xt, wt, bt))


# -- the narrow route: its decomposition, emulated -------------------------

def narrow_plan(itemsize, cin, cout):
    """The narrow launcher's decomposition (``plan_of`` in
    ``csrc/conv3d_igemm.cu``), worked out in Python: a box of 4 x ty x 32
    voxels (z, y, x); a thread owns 4 voxels along z at one (y, x) and
    ``cot`` output channels (1, 4 up to Cout 4, else 8), ``cs`` threads
    share a voxel; the halo comes in vectors of ``civ`` channels (1 at Cin
    1, 4 up to Cin 4, else 16 bytes); 8 warps a block where the slices
    allow. The card tests hold ``adell_conv3d_narrow_plan`` to
    ``NARROW_PLANS``."""
    civ = 1 if cin == 1 else 4 if cin <= 4 else 16 // itemsize
    cot = 1 if cout == 1 else 4 if cout <= 4 else 8
    cs = -(-cout // cot)
    ty = 1 if cs >= 8 else 8 // cs
    return (4, ty, 32, cot, cs, civ)


#: (itemsize, Cin, Cout) -> (tz, ty, tx, cot, cs, civ), worked out by hand
NARROW_PLANS = {
    (2, 1, 1): (4, 8, 32, 1, 1, 1), (2, 1, 32): (4, 2, 32, 8, 4, 1),
    (2, 32, 1): (4, 8, 32, 1, 1, 8), (4, 32, 1): (4, 8, 32, 1, 1, 4),
    (2, 1, 16): (4, 4, 32, 8, 2, 1), (2, 3, 3): (4, 8, 32, 4, 1, 4),
    (2, 3, 32): (4, 2, 32, 8, 4, 4), (2, 32, 3): (4, 8, 32, 4, 1, 8),
    (4, 4, 64): (4, 1, 32, 8, 8, 4), (2, 24, 1): (4, 8, 32, 1, 1, 8),
    (2, 1, 24): (4, 2, 32, 8, 3, 1),
}


def test_narrow_plan_by_hand():
    for (itemsize, cin, cout), plan in NARROW_PLANS.items():
        assert narrow_plan(itemsize, cin, cout) == plan


def emulate_narrow_conv(x, w, bias, itemsize):
    """The narrow kernel's decomposition in numpy (f32): for each box of
    ``narrow_plan`` and each vector of ``civ`` input channels, the halo
    (zeros outside the volume and past Cin) is cut once; for each (dy, dx)
    column a thread takes its 6 halo rows along z and uses them for the
    three dz taps, summing channel by channel into the 4 voxels and ``cot``
    channels it owns. Returns the output and how often each output element
    was stored (ragged boxes and channel slices past Cout are computed and
    not stored)."""
    b, d, h, wd, cin = x.shape
    cout = w.shape[-1]
    tz, ty, tx, cot, cs, civ = narrow_plan(itemsize, cin, cout)
    cin_s, cout_p = -(-cin // civ) * civ, cs * cot
    nz, ny, nx = -(-d // tz), -(-h // ty), -(-wd // tx)
    xp = np.zeros((b, nz * tz + 2, ny * ty + 2, nx * tx + 2, cin_s),
                  np.float32)
    xp[:, 1:d + 1, 1:h + 1, 1:wd + 1, :cin] = x
    wp = np.zeros((3, 3, 3, cin_s, cout_p), np.float32)
    wp[..., :cin, :cout] = w
    out = np.zeros((b, d, h, wd, cout), np.float32)
    stored = np.zeros(out.shape, np.int64)
    for bi in range(b):
        for z0 in range(0, nz * tz, tz):
            for y0 in range(0, ny * ty, ty):
                for x0 in range(0, nx * tx, tx):
                    # every thread of the box at once: [z, y, x, channel]
                    acc = np.zeros((tz, ty, tx, cout_p), np.float32)
                    for c0 in range(0, cin_s, civ):
                        halo = xp[bi, z0:z0 + tz + 2, y0:y0 + ty + 2,
                                  x0:x0 + tx + 2, c0:c0 + civ]
                        for dy in range(3):
                            for dx in range(3):
                                col = halo[:, dy:dy + ty, dx:dx + tx]
                                for dz in range(3):
                                    for c in range(civ):
                                        acc += (col[dz:dz + tz, ..., c, None]
                                                * wp[dz, dy, dx, c0 + c])
                    zs, ys = min(tz, d - z0), min(ty, h - y0)
                    xs = min(tx, wd - x0)
                    for s in range(cs):
                        cols = slice(s * cot, min((s + 1) * cot, cout))
                        out[bi, z0:z0 + zs, y0:y0 + ys, x0:x0 + xs,
                            cols] = acc[:zs, :ys, :xs, cols] + bias[cols]
                        stored[bi, z0:z0 + zs, y0:y0 + ys, x0:x0 + xs,
                               cols] += 1
    return out, stored


NARROW_SHAPES = [(1, 7, 9, 5), (2, 3, 5, 7), (1, 1, 1, 1)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("cin,cout", [(1, 16), (3, 8), (24, 1), (32, 3),
                                      (1, 1), (4, 64), (64, 4), (1, 24)])
@pytest.mark.parametrize("spatial", NARROW_SHAPES, ids=str)
def test_narrow_decomposition_stores_every_output_once(spatial, cin, cout,
                                                       itemsize):
    x, w, b = _inputs(13, spatial + (cin,), cout)
    _, stored = emulate_narrow_conv(x, w, b, itemsize)
    assert (stored == 1).all()


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("x_shape,cout", [((1, 7, 9, 5, 1), 16),
                                          ((2, 3, 5, 7, 3), 8),
                                          ((1, 7, 9, 5, 24), 1),
                                          ((2, 3, 5, 7, 32), 3)])
def test_narrow_emulation_matches_reference_and_jax(x_shape, cout, itemsize):
    x, w, b = _inputs(14, x_shape, cout)
    got, _ = emulate_narrow_conv(x, w, b, itemsize)
    want = kconv.conv3d_igemm_reference(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    ).numpy()
    jax_want = np.asarray(conv3d_xla(jnp.asarray(x), jnp.asarray(w))) + b
    # f32 sums of the same products in different orders
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(got - jax_want).max() <= 1e-5 * np.abs(jax_want).max()


@pytest.mark.parametrize("x_shape,cout", [((1, 3, 128, 8, 1), 16),
                                          ((1, 3, 128, 8, 32), 1)])
def test_narrow_reference_matches_pallas_interpret(x_shape, cout):
    """The narrow route's plain path against the TPU kernel, which takes
    Cin = 1 and Cout = 1, run in interpret mode."""
    x, w, _ = _inputs(15, x_shape, cout)
    real = pconv_mod.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return real(*args, **kwargs)

    pconv_mod.pl.pallas_call = patched
    try:
        want = np.asarray(
            pconv_mod.conv3d_pallas_raw(jnp.asarray(x), jnp.asarray(w))
        )
    finally:
        pconv_mod.pl.pallas_call = real
    got = kconv.conv3d_igemm_reference(
        torch.from_numpy(x), torch.from_numpy(w)
    ).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < TOL


def test_narrow_route_counts_nothing_on_the_cpu():
    x, w, b = _inputs(16, (1, 4, 4, 8, 1), 32)
    for dtype in (torch.bfloat16, torch.float32):
        xt, wt, bt = (torch.from_numpy(a).to(dtype) for a in (x, w, b))
        before = (kconv.conv3d_igemm.narrow_launches,
                  kconv.conv3d_igemm_dx.narrow_launches,
                  kconv.conv3d_igemm.launches)
        y = kconv.conv3d_igemm_train(xt.requires_grad_(), wt, bt)
        y.float().sum().backward()
        assert (kconv.conv3d_igemm.narrow_launches,
                kconv.conv3d_igemm_dx.narrow_launches,
                kconv.conv3d_igemm.launches) == before


# -- dW: the wgrad route and its decomposition, emulated --------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cin", [1, 3, 8, 16, 48, 64, 256])
@pytest.mark.parametrize("cout", [1, 4, 8, 24, 32, 256, 264])
def test_wgrad_route(dtype, cin, cout):
    """bf16 with Cin a multiple of 16, Cout of 8 and Cout <= 256 takes the
    wgrad kernel; the stems (Cin 1, 3), Cin 8, Cout 1 or 4, Cout past 256
    and every f32 call take the patch product."""
    want = ("wgmma" if dtype == torch.bfloat16 and cin % 16 == 0
            and cout % 8 == 0 and cout <= 256 else "patches")
    assert kconv.wgrad_route(dtype, cin, cout) == want
    # the kernel's classes are the forward's wgmma classes
    if want == "wgmma":
        assert kconv.conv_route(dtype, cin, cout) == "wgmma"


def _wgrad_rows(plan, cin):
    """How often each dW row (tap, ci) is stored by the blocks of the
    plan: chunk c, group, warpgroup and tile give 64 rows (tap, ci_local)
    of the chunk, rows past its 27 * ck are not stored."""
    counts = np.zeros((27, cin), np.int64)
    for c in range(cin // plan.ck):
        for grp in range(plan.groups):
            for wg in range(plan.nwg):
                for t in range(plan.t):
                    tile = (grp * plan.nwg + wg) * plan.t + t
                    for r in range(tile * 64, tile * 64 + 64):
                        if r // plan.ck < 27:
                            counts[r // plan.ck, c * plan.ck + r % plan.ck] += 1
    return counts


def _check_wgrad_plan(b, d, h, w, cin, cout, n_sm=132):
    plan = kconv.wgrad_plan(b, d, h, w, cin, cout, n_sm)
    box = (plan.tz, plan.ty, plan.tx)
    assert plan.tz * plan.ty * plan.tx == kconv.WGRAD_VOXELS
    # the forward's box policy, within the limits of the wgrad kernel
    voxels, max_halo = kconv.wgrad_limits(cin, cout)
    assert box == kconv.plan_box(d, h, w, voxels, max_halo)
    assert (plan.tz + 2) * (plan.ty + 2) * (plan.tx + 2) <= max_halo
    # every voxel once across the boxes, every box once across the splits
    assert (_box_cover(d, h, w, box) == 1).all()
    assert plan.boxes == b * (-(-d // plan.tz) * -(-h // plan.ty)
                              * -(-w // plan.tx))
    seen = np.zeros(plan.boxes, np.int64)
    for s in range(plan.splits):
        start, stop = plan.split_range(s)
        assert start < stop
        seen[start:stop] += 1
    assert (seen == 1).all()
    # every (tap, ci) row once across the M groups, every column once
    assert (_wgrad_rows(plan, cin) == 1).all()
    assert plan.n_blocks * plan.nb >= cout > (plan.n_blocks - 1) * plan.nb
    # the sums fit the register budget, the buffers the shared memory
    assert plan.t * plan.nb // 2 <= kconv.WGRAD_ACC or plan.t == 1
    assert plan.smem <= kconv.WGRAD_MAX_SMEM
    blocks = cin // plan.ck * plan.groups * plan.n_blocks
    assert plan.splits == min(plan.boxes, max(1, -(-2 * n_sm // blocks)))
    return plan


# the U-Net's dW classes at B=4, UNETR's at B=2, ragged volumes with several
# channel chunks, a card of few SMs (one split)
WGRAD_PLAN_SHAPES = [
    (4, 128, 128, 32, 32, 32), (4, 128, 128, 32, 64, 32),
    (4, 128, 128, 32, 64, 64), (4, 64, 64, 16, 32, 32),
    (4, 32, 32, 8, 128, 128), (4, 16, 16, 4, 256, 256),
    (4, 16, 16, 4, 256, 128), (4, 8, 8, 2, 128, 256),
    (2, 256, 256, 64, 32, 16), (2, 256, 256, 64, 16, 16),
    (1, 7, 9, 5, 48, 24), (2, 12, 10, 9, 96, 32), (1, 7, 9, 5, 16, 8),
    (1, 1, 1, 1, 64, 64), (3, 5, 6, 10, 32, 136),
]


@pytest.mark.parametrize("shape", WGRAD_PLAN_SHAPES, ids=str)
def test_wgrad_plan_covers_every_voxel_and_row_once(shape):
    _check_wgrad_plan(*shape)


def test_wgrad_plan_by_hand():
    """32->32 at B=4, 128x128x32: N 32 (16 registers a tile), so a chunk of
    32 channels, whose 14 tiles of 64 rows (two taps a tile) two
    warpgroups hold at 7 tiles (112 registers); one group, so 264 splits
    fill 132 SMs twice, over 8192 boxes of 4x8x8; two stages of a 16 KB
    cotangent tile and a 600-row halo of 80-byte rows. 64->64: N 64 leaves
    a chunk of 16 (7 tiles, 4 a warpgroup at 32 registers), four chunks,
    66 splits. 256->256 at 16x16x4: 16 chunks of 16 by 4 N blocks of 64,
    5 splits of 16 boxes of 8x8x4."""
    p = kconv.wgrad_plan(4, 128, 128, 32, 32, 32)
    assert p == (4, 8, 8, 32, 32, 7, 2, 14, 1, 1, 264, 8192,
                 2 * (16384 + 48128) + 1024)
    # half the shared memory a stage, less the 16 KB tile, in whole KB:
    # 99328 bytes, 1241 rows of 80 bytes
    assert kconv.wgrad_limits(32, 32) == (256, 1241)
    p = kconv.wgrad_plan(4, 128, 128, 32, 64, 64)
    assert (p.ck, p.nb, p.t, p.tiles, p.groups, p.splits) == (
        16, 64, 4, 7, 1, 66)
    p = kconv.wgrad_plan(4, 16, 16, 4, 256, 256)
    assert (p.ck, p.nb, p.t, p.groups, p.n_blocks, p.splits, p.boxes) == (
        16, 64, 4, 1, 4, 5, 16)
    assert (p.tz, p.ty, p.tx) == (8, 8, 4)
    assert p.smem == 2 * (32768 + 29696) + 1024
    # UNETR's 32->16: N 16 lets a chunk of 32 through (7 tiles a
    # warpgroup, 56 registers)
    p = kconv.wgrad_plan(2, 256, 256, 64, 32, 16)
    assert (p.ck, p.nb, p.t, p.groups) == (32, 16, 7, 1)
    assert kconv.wgrad_plan(4, 32, 32, 8, 128, 16).ck == 64
    with pytest.raises(ValueError):
        kconv.wgrad_plan(1, 8, 8, 8, 8, 16)
    with pytest.raises(ValueError):
        kconv.wgrad_limits(16, 264)


@settings(max_examples=30, deadline=None)
@given(
    b=st.integers(1, 3), d=st.integers(1, 40), h=st.integers(1, 40),
    w=st.integers(1, 40),
    cin=st.sampled_from([16, 32, 48, 64, 96, 128, 256]),
    cout=st.integers(1, 32).map(lambda n: 8 * n),
    n_sm=st.sampled_from([1, 8, 132]),
)
def test_wgrad_plan_property(b, d, h, w, cin, cout, n_sm):
    _check_wgrad_plan(b, d, h, w, cin, cout, n_sm)


def emulate_wgrad(x, g, n_sm=132):
    """The wgrad kernel's decomposition in f32 (x, g: float32 arrays,
    bf16-valued for a bf16 run): each split walks its boxes; for each box
    the input halo (zeros outside the volume) and the cotangent tile (zero
    rows outside it) are cut once, and every tap's rows of dW take the halo
    rows shifted by the tap times the tile. The splits' f32 partials are
    summed in order."""
    b, d, h, wd, cin = x.shape
    cout = g.shape[-1]
    plan = kconv.wgrad_plan(b, d, h, wd, cin, cout, n_sm)
    tz, ty, tx = plan.tz, plan.ty, plan.tx
    nz, ny, nx = -(-d // tz), -(-h // ty), -(-wd // tx)
    xp = np.zeros((b, nz * tz + 2, ny * ty + 2, nx * tx + 2, cin), np.float32)
    xp[:, 1:d + 1, 1:h + 1, 1:wd + 1] = x
    gp = np.zeros((b, nz * tz, ny * ty, nx * tx, cout), np.float32)
    gp[:, :d, :h, :wd] = g
    parts = np.zeros((plan.splits, 27, cin, cout), np.float32)
    for s in range(plan.splits):
        for box in range(*plan.split_range(s)):
            bi, rest = divmod(box, nz * ny * nx)
            bz, rest = divmod(rest, ny * nx)
            by, bx = divmod(rest, nx)
            z0, y0, x0 = bz * tz, by * ty, bx * tx
            halo = xp[bi, z0:z0 + tz + 2, y0:y0 + ty + 2, x0:x0 + tx + 2]
            tile = gp[bi, z0:z0 + tz, y0:y0 + ty, x0:x0 + tx].reshape(
                -1, cout)
            for t in range(27):
                dz, dy, dx = t // 9, t // 3 % 3, t % 3
                rows = halo[dz:dz + tz, dy:dy + ty, dx:dx + tx]
                parts[s, t] += rows.reshape(-1, cin).T @ tile
    total = parts[0].copy()
    for s in range(1, plan.splits):
        total += parts[s]
    return total.reshape(3, 3, 3, cin, cout)


WGRAD_EMULATION_SHAPES = [((1, 7, 9, 5, 48), 24), ((2, 3, 5, 7, 16), 8),
                          ((1, 5, 6, 10, 32), 16)]


def _wgrad_inputs(seed, x_shape, cout):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=x_shape).astype(np.float32)
    g = rng.normal(size=x_shape[:4] + (cout,)).astype(np.float32)
    return x, g


def _jax_dw(x, g, dtype):
    xj, gj = jnp.asarray(x, dtype), jnp.asarray(g, dtype)
    wj = jnp.zeros((3, 3, 3, x.shape[-1], g.shape[-1]), dtype)
    _, vjp = jax.vjp(
        lambda ww: conv3d_im2col_trainable(xj, ww, (1, 1, 1), "SAME"), wj)
    return np.asarray(vjp(gj)[0].astype(jnp.float32))


@pytest.mark.parametrize("n_sm", [132, 1])
@pytest.mark.parametrize("x_shape,cout", WGRAD_EMULATION_SHAPES, ids=str)
def test_wgrad_emulation_matches_reference_and_jax_f32(x_shape, cout, n_sm):
    x, g = _wgrad_inputs(17, x_shape, cout)
    got = emulate_wgrad(x, g, n_sm)
    want = kconv.conv3d_weight_grad_reference(
        torch.from_numpy(x), torch.from_numpy(g)).numpy()
    jax_want = _jax_dw(x, g, jnp.float32)
    # f32 sums of the same products in different orders
    for ref in (want, jax_want):
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("x_shape,cout", WGRAD_EMULATION_SHAPES, ids=str)
def test_wgrad_emulation_matches_reference_and_jax_bf16(x_shape, cout):
    """bf16 inputs: exact products summed in f32 by split, the splits
    summed in order and rounded once to bf16, as the kernel does; the plain
    version and the JAX VJP round their f32 sums once too, so the three
    differ by at most one bf16 ulp (2^-7) of the scale."""
    x, g = _wgrad_inputs(18, x_shape, cout)
    xb, gb = (torch.from_numpy(a).bfloat16() for a in (x, g))
    got = torch.from_numpy(
        emulate_wgrad(xb.float().numpy(), gb.float().numpy())
    ).bfloat16().float().numpy()
    want = kconv.conv3d_weight_grad_reference(xb, gb).float().numpy()
    jax_want = _jax_dw(xb.float().numpy(), gb.float().numpy(), jnp.bfloat16)
    for ref in (want, jax_want):
        assert np.abs(got - ref).max() <= 2.0**-7 * np.abs(ref).max()


# the patch route's chunks: (x shape, Cout, budget in patch elements of
# one D-plane of one sample, the split it forces)
PATCH_CHUNK_CASES = [
    ((8, 4, 5, 6, 8), 16, 2 * 4, "samples"),   # two samples a chunk
    ((2, 5, 4, 3, 16), 8, 2, "slabs"),          # two planes a chunk
    ((1, 7, 3, 4, 4), 8, 2, "slabs"),           # 2 + 2 + 2 + 1 planes
    ((2, 3, 4, 5, 8), 8, 10 ** 6, "whole"),
]


def _plane_bytes(shape, dtype):
    """A chunked product's bytes for one D-plane of one sample (the bf16
    whole batch's one product takes a third of that, having no f32
    copy: the cases' budgets are below it)."""
    return shape[2] * shape[3] * 27 * shape[4] * kconv._patch_bytes(dtype)


def _within_one_ulp(a, b, scale):
    """bf16 ``a`` and ``b``, each the rounding of f32 sums that differ by
    at most 1e-6 of ``scale``: one bf16 ulp (2^-7 of the power of two at
    or below the larger) apart, plus that difference."""
    m = np.maximum(np.abs(a), np.abs(b))
    ulp = 2.0 ** (np.floor(np.log2(np.where(m > 0, m, 1.0))) - 7)
    return bool((np.abs(a - b) <= ulp + 1e-6 * scale).all())


@pytest.mark.parametrize("x_shape,cout,planes,split", PATCH_CHUNK_CASES,
                         ids=[c[3] + str(c[0]) for c in PATCH_CHUNK_CASES])
def test_patch_chunks_cover_the_batch_within_the_budget(x_shape, cout,
                                                        planes, split):
    """Each (sample, plane) is in exactly one chunk; a chunk's patch
    tensor fits the budget; whole samples where one fits, else slabs of
    planes of one sample."""
    for dtype in (torch.float32, torch.bfloat16):
        budget = planes * _plane_bytes(x_shape, dtype)
        chunks = kconv.patch_chunks(x_shape, dtype, budget)
        b, d = x_shape[:2]
        seen = np.zeros((b, d), int)
        for b0, b1, z0, z1 in chunks:
            seen[b0:b1, z0:z1] += 1
            assert (b1 - b0) * (z1 - z0) * _plane_bytes(
                x_shape, dtype) <= budget
            if split == "slabs":
                assert b1 - b0 == 1
            else:
                assert (z0, z1) == (0, d)
        assert (seen == 1).all()
        assert (len(chunks) == 1) == (split == "whole")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("x_shape,cout,planes,split", PATCH_CHUNK_CASES,
                         ids=[c[3] + str(c[0]) for c in PATCH_CHUNK_CASES])
def test_chunked_patch_product_matches_single_product(x_shape, cout, planes,
                                                      split, dtype):
    """The f32 sums of the chunked product (by samples, or by slabs of
    planes cut with their halo) against the whole batch's, within 1e-6
    relative; the rounded dW against the JAX VJP's (f32 1e-5 of the
    scale, bf16 one bf16 ulp 2^-7, as the emulation tests hold them) and
    against the plain version at the default budget: in f32 the one
    chunk within 1e-6, in bf16 the single bf16 product (f32 sums in the
    library, rounded once) within one bf16 ulp of each element plus
    1e-6 of the scale."""
    x, g = (torch.from_numpy(a).to(dtype)
            for a in _wgrad_inputs(23, x_shape, cout))
    budget = planes * _plane_bytes(x_shape, dtype)
    chunks = kconv.patch_chunks(x_shape, dtype, budget)
    whole = [(0, x_shape[0], 0, x_shape[1])]
    got = kconv.patch_sums(x, g, chunks)
    want = kconv.patch_sums(x, g, whole)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    dw = kconv.conv3d_weight_grad_reference(x, g, budget=budget)
    assert dw.dtype == dtype and dw.shape == (3, 3, 3, x_shape[-1], cout)
    jax_want = _jax_dw(x.float().numpy(), g.float().numpy(),
                       jnp.float32 if dtype == torch.float32
                       else jnp.bfloat16)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert np.abs(dw.float().numpy() - jax_want).max() <= tol * np.abs(
        jax_want).max()
    single = kconv.conv3d_weight_grad_reference(x, g)
    assert single.dtype == dtype
    scale = float(single.float().abs().max())
    if dtype == torch.float32:
        assert float((dw - single).abs().max()) <= 1e-6 * scale
    else:
        assert _within_one_ulp(dw.float().numpy(), single.float().numpy(),
                               scale)


def test_weight_grad_takes_plain_path_on_cpu():
    """On CPU tensors the wrapper is the plain version and counts neither a
    launch nor a patch call, on either route's classes; the Function's dW
    goes through it."""
    for x_shape, cout, dtype in (((1, 4, 5, 6, 16), 8, torch.bfloat16),
                                 ((1, 4, 5, 6, 1), 32, torch.bfloat16),
                                 ((1, 4, 5, 6, 16), 8, torch.float32)):
        x, g = (torch.from_numpy(a).to(dtype)
                for a in _wgrad_inputs(19, x_shape, cout))
        before = (kconv.conv3d_weight_grad.launches,
                  kconv.conv3d_weight_grad.patch_calls)
        got = kconv.conv3d_weight_grad(x, g)
        assert torch.equal(got, kconv.conv3d_weight_grad_reference(x, g))
        w = torch.zeros((3, 3, 3, x_shape[-1], cout), dtype=dtype,
                        requires_grad=True)
        y = kconv.conv3d_igemm_train(x, w)
        (dw,) = torch.autograd.grad(y, [w], g)
        assert torch.equal(dw, got)
        assert (kconv.conv3d_weight_grad.launches,
                kconv.conv3d_weight_grad.patch_calls) == before
