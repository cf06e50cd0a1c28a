"""
The port's device augmentation against the JAX package's, on the CPU.

The same numpy volumes, matrices, angles and gates go through both sides;
random gates are injected where the two frameworks' generators would
differ. The plain intensity chain is held against the TPU kernel run in
interpret mode with its noise off (as ``tests/test_pallas_ops.py`` runs
it), and the noise by its moments; the plain version's Philox stream
(the CUDA kernel's) against Random123's known answers and Python's
integers. Tolerance 1e-5 on unit-scale f32 data unless stated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adell_mri_tpu.ops.pallas.intensity as jint
from adell_mri_tpu.transforms import intensity as jI
from adell_mri_tpu.transforms import pipeline as jpipe
from adell_mri_tpu.transforms import spatial as jS
from adell_mri_torch.ops.kernels import intensity as tint
from adell_mri_torch.transforms import intensity as tI
from adell_mri_torch.transforms import pipeline as tpipe
from adell_mri_torch.transforms import spatial as tS

TOL = 1e-5


def _vol(seed, shape=(16, 16, 8, 2)):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _affine(seed, shape):
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-0.4, 0.4, 3).astype(np.float32)
    scales = rng.uniform(0.9, 1.1, 3).astype(np.float32)
    shears = rng.uniform(-0.1, 0.1, 6).astype(np.float32)
    c = np.eye(4, dtype=np.float32)
    c[:3, 3] = (np.asarray(shape) - 1) / 2
    ci = np.eye(4, dtype=np.float32)
    ci[:3, 3] = -c[:3, 3]
    rot = np.asarray(jS.rotation_matrix(3, jnp.asarray(angles)))
    ss = np.asarray(jS.scale_shear_matrix(3, jnp.asarray(scales),
                                          jnp.asarray(shears)))
    m = c @ rot @ ss @ ci
    m[:3, 3] += rng.uniform(-2, 2, 3)
    return m.astype(np.float32), angles, scales, shears


def test_matrix_builders_match_jax():
    _, angles, scales, shears = _affine(0, (16, 16, 8))
    np.testing.assert_allclose(
        tS.rotation_matrix(3, torch.from_numpy(angles)).numpy(),
        np.asarray(jS.rotation_matrix(3, jnp.asarray(angles))), atol=1e-6)
    np.testing.assert_allclose(
        tS.rotation_matrix(2, torch.from_numpy(angles[:1])).numpy(),
        np.asarray(jS.rotation_matrix(2, jnp.asarray(angles[:1]))),
        atol=1e-6)
    np.testing.assert_allclose(
        tS.scale_shear_matrix(3, torch.from_numpy(scales),
                              torch.from_numpy(shears)).numpy(),
        np.asarray(jS.scale_shear_matrix(3, jnp.asarray(scales),
                                         jnp.asarray(shears))), atol=1e-6)
    np.testing.assert_allclose(
        tS.center_matrix((16, 16, 8), -1.0).numpy(),
        np.asarray(jS.center_matrix((16, 16, 8), -1.0)), atol=0)


@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("cval", [0.0, -1.5])
def test_warp_affine_matches_jax(method, cval):
    vol = _vol(1)
    if method == "nearest":
        vol = np.round(vol * 3)  # label-like values
    m, *_ = _affine(2, vol.shape[:3])
    got = tS.warp_affine(torch.from_numpy(vol), torch.from_numpy(m),
                         method=method, cval=cval).numpy()
    want = np.asarray(jS.warp_affine(jnp.asarray(vol), jnp.asarray(m),
                                     method=method, cval=cval))
    assert got.shape == want.shape
    # the warp must reach the border: some voxels take cval
    assert (want == cval).any() and (want != cval).any()
    np.testing.assert_allclose(got, want, atol=TOL)


def test_warp_affine_out_shape_matches_jax():
    vol = _vol(3)
    m, *_ = _affine(4, vol.shape[:3])
    got = tS.warp_affine(torch.from_numpy(vol), torch.from_numpy(m),
                         out_shape=(10, 12, 6)).numpy()
    want = np.asarray(jS.warp_affine(jnp.asarray(vol), jnp.asarray(m),
                                     out_shape=(10, 12, 6)))
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.fixture
def gates(monkeypatch):
    """Injects the same flip gates into both sides' Bernoulli draws."""
    box = {}

    def jax_bernoulli(key, p=0.5, shape=None):
        g = box["gates"]
        if shape is None:  # one scalar draw per axis
            box["i"] += 1
            return jnp.asarray(g[box["i"] - 1])
        return jnp.asarray(g)

    def torch_bernoulli(generator, prob, n, device):
        return torch.tensor(box["gates"][:n], device=device)

    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    monkeypatch.setattr(tS, "_bernoulli", torch_bernoulli)

    def set_gates(g):
        box["gates"], box["i"] = list(g), 0

    return set_gates


@pytest.mark.parametrize("flips", [(1, 0, 1), (0, 1, 1), (0, 0, 0)])
def test_compose_flips_matches_jax(gates, flips):
    gates([bool(f) for f in flips])
    shape = (16, 16, 8)
    m, *_ = _affine(5, shape)
    got = tS.compose_flips(None, torch.from_numpy(m), shape, (0, 1, 2))
    want = jS.compose_flips(jax.random.PRNGKey(0), jnp.asarray(m), shape,
                            (0, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("flips", [(1, 0, 1), (0, 1, 0)])
def test_random_flip_with_matrix_matches_jax(gates, flips):
    vol = _vol(6)
    gates([bool(f) for f in flips])
    got, gm = tS.random_flip_with_matrix(None, torch.from_numpy(vol),
                                         (0, 1, 2), 3)
    gates([bool(f) for f in flips])
    want, wm = jS.random_flip_with_matrix(jax.random.PRNGKey(0),
                                          jnp.asarray(vol), (0, 1, 2), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=0)
    gates([bool(f) for f in flips])
    np.testing.assert_array_equal(
        tS.random_flip(None, torch.from_numpy(vol), (0, 1, 2)).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("alpha", [0.4, 0.55, 0.7])
def test_gibbs_ringing_matches_jax(alpha):
    vol = _vol(7)
    got = tI.gibbs_ringing(torch.Generator().manual_seed(0),
                           torch.from_numpy(vol), alpha_range=(alpha, alpha))
    want = jI.gibbs_ringing(jax.random.PRNGKey(0), jnp.asarray(vol),
                            alpha_range=(alpha, alpha))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_random_affine_matrix_is_identity_when_ranges_are_zero():
    m = tS.random_affine_matrix(torch.Generator().manual_seed(0),
                                (16, 16, 8))
    np.testing.assert_allclose(m.numpy(), np.eye(4), atol=1e-6)
    m = tS.random_affine_matrix(torch.Generator().manual_seed(0),
                                (16, 16, 8), rotate_range=(0.3, 0.3, 0.1))
    lin = m[:3, :3].numpy()
    np.testing.assert_allclose(lin @ lin.T, np.eye(3), atol=1e-5)
    # rotation about the centre: the centre maps to itself
    c = np.array([7.5, 7.5, 3.5, 1.0], np.float32)
    np.testing.assert_allclose(m.numpy() @ c, c, atol=1e-4)


# -- intensity ---------------------------------------------------------------


def _par(x):
    b = x.shape[0]
    lo = x.reshape(b, -1).min(1)
    hi = x.reshape(b, -1).max(1)
    gamma = np.linspace(0.6, 1.4, b)
    scale = np.linspace(0.9, 1.1, b)
    shift = np.linspace(-0.1, 0.1, b)
    sigma = np.zeros(b)
    return np.stack([lo, hi, gamma, scale, shift, sigma], 1).astype(
        np.float32)


def test_plain_intensity_matches_pallas_interpret():
    x = np.random.default_rng(8).normal(size=(3, 16, 16, 8, 1)).astype(
        np.float32)
    par = _par(x)
    real = jint.pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return real(*args, **kwargs)

    jint.pl.pallas_call = patched
    try:
        # noise=False: interpret mode cannot lower the TPU PRNG
        want = np.asarray(jint._fused_batch_kernel_call(
            3, jnp.asarray(x), jnp.asarray(par), rician=False, noise=False))
    finally:
        jint.pl.pallas_call = real
    for noise, rician in ((False, False), (True, True)):
        # a Rician call whose sigma is 0 everywhere leaves the chain as it is
        got = tint.intensity_aug(
            torch.tensor([3]), torch.from_numpy(x), torch.from_numpy(par),
            rician=rician, noise=noise,
        ).numpy()
        np.testing.assert_allclose(got, want, atol=TOL)


def test_scalar_intensity_matches_jax():
    x = np.random.default_rng(9).normal(size=(16, 16, 8, 1)).astype(
        np.float32)
    lo, hi = float(x.min()), float(x.max())
    got = tint.fused_intensity_aug(0, torch.from_numpy(x), lo, hi, 1.2, 1.1,
                                   0.1, 0.0, rician=True).numpy()
    want = np.asarray(jint.fused_intensity_aug(0, jnp.asarray(x), lo, hi,
                                               1.2, 1.1, 0.1, 0.0,
                                               rician=True))
    np.testing.assert_allclose(got, want, atol=TOL)
    # sigma 0 with rician: negative voxels are not rectified
    assert got.min() < 0


def test_batch_intensity_parameters_match_jax():
    """Degenerate ranges and probability 1 make the draws deterministic:
    lo/hi and the std shift come from the data on both sides."""
    x = np.random.default_rng(10).uniform(size=(2, 16, 16, 8, 1)).astype(
        np.float32)
    kw = dict(gamma_range=(1.3, 1.3), scale_delta=0.0, shift_delta=0.0,
              sigma=0.0, std_shift=True)
    got = tint.fused_intensity_aug_batch(
        torch.Generator().manual_seed(0), torch.from_numpy(x), **kw).numpy()
    want = np.asarray(jint.fused_intensity_aug_batch(
        jax.random.PRNGKey(0), jnp.asarray(x), **kw))
    np.testing.assert_allclose(got, want, atol=TOL)


def test_intensity_noise_moments():
    """Every gate on: the noise residual of a Gaussian call is N(0,
    sigma^2), that of a Rician call matches a numpy Rician draw on the
    same clean volume; both within 6 standard errors."""
    rng = np.random.default_rng(11)
    x = (0.5 + 0.5 * rng.uniform(size=(2, 32, 32, 16, 1))).astype(
        np.float32)
    par = _par(x)
    par[:, 5] = sigma = 0.05
    xt, pt = torch.from_numpy(x), torch.from_numpy(par)
    clean = tint.intensity_aug(torch.tensor([1]), xt, pt, noise=False)
    n = x.size
    for rician in (False, True):
        out = tint.intensity_aug(torch.tensor([2]), xt, pt, rician=rician)
        d = (out - clean).numpy().ravel()
        if rician:
            c = clean.numpy().ravel()
            ref = np.sqrt((c + sigma * rng.normal(size=n)) ** 2
                          + (sigma * rng.normal(size=n)) ** 2) - c
        else:
            ref = sigma * rng.normal(size=n)
        se = ref.std() / np.sqrt(n)
        assert abs(d.mean() - ref.mean()) < 6 * np.sqrt(2) * se
        # std of a sample std ~ std / sqrt(2n)
        assert abs(d.std() - ref.std()) < 6 * ref.std() / np.sqrt(n)


def test_rician_sigma_zero_sample_is_not_rectified():
    x = np.random.default_rng(12).normal(size=(3, 16, 16, 8, 1)).astype(
        np.float32)
    par = _par(x)
    par[:, 5] = [0.0, 0.05, 0.05]
    xt, pt = torch.from_numpy(x), torch.from_numpy(par)
    out = tint.intensity_aug(torch.tensor([4]), xt, pt, rician=True)
    clean = tint.intensity_aug(torch.tensor([4]), xt, pt, noise=False)
    np.testing.assert_array_equal(out[0].numpy(), clean[0].numpy())
    assert float(out[0].min()) < 0 and float(out[1:].min()) >= 0


# -- the kernel's Philox stream in the plain version --------------------------

_M32 = 0xFFFFFFFF


def _philox_py(counter, key):
    """Philox4x32-10 on Python integers, the oracle of the torch one."""
    c, (k0, k1) = list(counter), key
    for _ in range(10):
        p0 = 0xD2511F53 * c[0]
        p1 = 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & _M32, (p0 >> 32) ^ c[3] ^ k1,
             p0 & _M32]
        k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
    return c


@pytest.mark.parametrize("counter, key, want", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((_M32,) * 4, (_M32,) * 2, "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0), "d16cfe09 94fdcceb 5001e420 24126ea1"),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    """Random123's known answers for Philox4x32-10."""
    got = tint.philox4x32_10(torch.tensor(counter), torch.tensor(key))
    assert " ".join(f"{int(w):08x}" for w in got) == want
    assert " ".join(f"{w:08x}" for w in _philox_py(counter, key)) == want


def test_philox_matches_python_integers():
    """The torch Philox (16-bit halves in int64) against Python's
    unbounded integers on random counters and keys."""
    rng = np.random.default_rng(20)
    counters = rng.integers(0, 2**32, (64, 4), dtype=np.uint64)
    keys = rng.integers(0, 2**32, (64, 2), dtype=np.uint64)
    got = tint.philox4x32_10(torch.from_numpy(counters.astype(np.int64)),
                             torch.from_numpy(keys.astype(np.int64)))
    want = [_philox_py([int(w) for w in c], [int(w) for w in k])
            for c, k in zip(counters, keys)]
    assert got.tolist() == want


def test_philox_normals_follow_the_kernel_layout():
    """Element e of sample b, draw d: normal e % 4 of Philox at (e // 4,
    0, b, d) keyed by the seed's two words, Box-Muller (cos, sin of 2 pi
    u2) in float64 here;
    the seed as an int and as the kernel's int64 tensor give one stream."""
    seed = 2**40 + 12345
    got = tint.philox_normals(torch.tensor([seed]), 3, 37, 1, "cpu")
    assert torch.equal(got, tint.philox_normals(seed, 3, 37, 1, "cpu"))
    key = (seed & _M32, seed >> 32)
    for b, e in ((0, 0), (0, 5), (1, 36), (2, 17), (2, 3)):
        r = _philox_py((e // 4, 0, b, 1), key)
        p = (e % 4) // 2
        u1 = max(float(np.float32((r[2 * p] >> 9) / 2**23)), 1e-12)
        u2 = (r[2 * p + 1] >> 9) / 2**23
        rad = np.sqrt(-2 * np.log(u1))
        angle = 2 * np.pi * u2
        want = rad * (np.cos(angle) if e % 2 == 0 else np.sin(angle))
        assert abs(float(got[b, e]) - want) < 1e-5


def test_philox_normals_are_distinct():
    """No two (sample, element, draw) share a Box-Muller pair: a counter
    that collided would hand two voxels the same noise. A pair is two
    23-bit uniforms, so a chance collision among these 6144 pairs has
    odds of about 1e-6."""
    u = torch.stack([tint.philox_uniforms(torch.tensor([9]), 3, 1024, d,
                                          "cpu") for d in (0, 1)])
    k = (u * 2**23).long().reshape(-1, 2)
    pairs = k[:, 0] * 2**23 + k[:, 1]
    assert pairs.unique().numel() == pairs.numel() == 2 * 3 * 1024 * 2
    # each normal of an element is built from its own pair
    n = [tint.philox_normals(torch.tensor([9]), 3, 4096, d, "cpu")
         for d in (0, 1)]
    x = np.full((3, 4096), 2.0, np.float32)
    par = np.tile(np.float32([[0.0, 4.0, 1.0, 1.0, 0.0, 0.1]]), (3, 1))
    out = tint.intensity_aug(torch.tensor([9]), torch.from_numpy(x),
                             torch.from_numpy(par), rician=True)
    want = torch.sqrt((2.0 + 0.1 * n[0]) ** 2 + (0.1 * n[1]) ** 2)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)


# -- pipeline ----------------------------------------------------------------


@pytest.mark.parametrize(
    "flags", [["intensity", "noise", "affine", "flip"], ["shear"], []]
)
def test_augment_policy_from_flags_matches_jax(flags):
    kw = dict(scale_range=0.0, flip_axes=(0, 1, 2))
    got = dataclasses.asdict(tpipe.AugmentPolicy.from_flags(flags, **kw))
    want = dataclasses.asdict(jpipe.AugmentPolicy.from_flags(flags, **kw))
    assert got == want


def test_segmentation_augment_keeps_image_and_label_aligned():
    """With every op firing, geometry only: the image (linear) and the
    label (nearest) are warped by the same matrix, so an image that is
    its own label stays aligned with it."""
    rng = np.random.default_rng(13)
    label = np.zeros((2, 16, 16, 8), np.float32)
    label[:, 4:12, 5:11, 2:6] = 1.0
    policy = tpipe.AugmentPolicy.from_flags(
        ["affine", "flip"], prob=1.0, flip_prob=0.5, scale_range=0.0,
        flip_axes=(0, 1, 2))
    tr = tpipe.SegmentationTransforms(augmentations=policy)
    batch = {"image": torch.from_numpy(label[..., None]),
             "label": torch.from_numpy(label), "other": rng.normal(size=2)}
    out = tr.augment(torch.Generator().manual_seed(1), batch)
    assert out["image"].shape == (2, 16, 16, 8, 1)
    assert out["label"].shape == (2, 16, 16, 8)
    assert out["image"].dtype == out["label"].dtype == torch.float32
    assert set(np.unique(out["label"].numpy())) <= {0.0, 1.0}
    assert not np.array_equal(out["label"].numpy(), label)
    img = out["image"][..., 0].numpy()
    agree = ((img > 0.5) == (out["label"].numpy() > 0.5)).mean()
    assert agree > 0.97
    assert out["other"] is batch["other"]


def test_segmentation_augment_full_policy_runs():
    x = np.random.default_rng(14).uniform(size=(2, 16, 16, 8, 1)).astype(
        np.float32)
    lab = (x[..., 0] > 0.7).astype(np.float32)
    policy = tpipe.AugmentPolicy.from_flags(
        ["intensity", "noise", "affine", "flip"], prob=1.0,
        scale_range=0.0, flip_axes=(0, 1, 2))
    tr = tpipe.SegmentationTransforms(augmentations=policy)
    out = tr.augment(torch.Generator().manual_seed(2),
                     {"image": torch.from_numpy(x),
                      "label": torch.from_numpy(lab)})
    assert torch.isfinite(out["image"]).all()
    assert not torch.equal(out["image"], torch.from_numpy(x))
