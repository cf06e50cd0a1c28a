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
    g = torch.ones((1, 4, 4, 4, 3))
    dw = kconv.conv3d_weight_grad(torch.from_numpy(x), g)
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
