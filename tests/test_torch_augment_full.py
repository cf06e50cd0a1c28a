"""
The port's whole augmentation against the JAX package's, on the CPU.

``resize_volume`` against ``jax.image.resize`` (cubic, nearest, linear) at
odd sizes; the elastic warp, every op of ``transforms/intensity.py`` and
each of the 27 TrivialAugment ops with JAX's draws handed to the port's
cores; ``_augment_one`` with all ten flags and every gate forced on or
off (image, label and returned geometry); the policy's fields. JAX's
draws come from the same keys its functions split, so both sides compute
the same function of the same numbers. The port's own draws are held to
their distributions. Tolerances: 1e-6 of the output's scale for the
resize (JAX's f32 einsum is itself about 2e-6 from the f64 result on
normal inputs of scale 3), 1e-5 on unit-scale f32 data elsewhere, 1e-4 of
max|out| for the k-space spike, labels exact except voxels sampled within
1e-4 of a half-integer (at most 0.1 % of them).
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.transforms import augment as jA
from adell_mri_tpu.transforms import intensity as jI
from adell_mri_tpu.transforms import pipeline as jpipe
from adell_mri_tpu.transforms import spatial as jS
from adell_mri_torch.models.layers.multi_resolution import (
    cubic_resize_weights,
    resize_volume,
)
from adell_mri_torch.transforms import augment as tA
from adell_mri_torch.transforms import intensity as tI
from adell_mri_torch.transforms import pipeline as tpipe
from adell_mri_torch.transforms import spatial as tS

TOL = 1e-5
SHAPE = (16, 16, 8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _vol(seed, shape=SHAPE + (2,)):
    return np.random.default_rng(seed).uniform(size=shape).astype(np.float32)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0)


# -- resize -------------------------------------------------------------------


@pytest.mark.parametrize("method", ["cubic", "nearest", "linear"])
@pytest.mark.parametrize(
    "shape,out",
    [((4, 4, 4, 1), (37, 9, 13, 1)), ((8, 13, 5), (13, 8, 5)),
     ((3, 4, 4, 4), (3, 16, 16, 8)), ((16, 7, 3), (5, 21, 2))],
)
def test_resize_volume_matches_jax(method, shape, out):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, method))
    got = resize_volume(_t(x), out, method).numpy()
    assert got.shape == want.shape
    _close(got, want, 1e-6 * max(1.0, float(np.abs(want).max())))


def test_cubic_resize_is_keys_with_renormalised_edges():
    """a = -0.5, not torch's bicubic -0.75: 1 -> 2 voxels of a step edge
    differ; the weights of every output sum to one, so ones stay ones."""
    w = cubic_resize_weights(4, 9).numpy()
    np.testing.assert_allclose(w.sum(0), 1.0, atol=1e-6)
    ones = resize_volume(torch.ones(4, 4, 4), (9, 9, 9), "cubic")
    np.testing.assert_allclose(ones.numpy(), 1.0, atol=1e-6)
    x = torch.tensor([0.0, 0.0, 1.0, 1.0])
    mid = resize_volume(x, (8,), "cubic").numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(x.numpy()), (8,),
                                       "cubic"))
    np.testing.assert_allclose(mid, want, atol=1e-7)


def test_nearest_resize_is_half_pixel():
    """JAX's nearest samples floor((i + 0.5) in / out), torch's
    nearest-exact; at 8 -> 13 torch's nearest differs at 4 of 13
    positions."""
    import torch.nn.functional as F

    x = torch.arange(8.0)
    got = resize_volume(x, (13,), "nearest").numpy()
    want = np.asarray(jax.image.resize(jnp.arange(8.0), (13,), "nearest"))
    np.testing.assert_array_equal(got, want)
    modes = {m: F.interpolate(x[None, None], size=13, mode=m)[0, 0].numpy()
             for m in ("nearest", "nearest-exact")}
    np.testing.assert_array_equal(modes["nearest-exact"], want)
    assert (modes["nearest"] != want).sum() == 4


# -- elastic warp -------------------------------------------------------------


def _jax_grid(key, magnitude=2.0):
    return jax.random.normal(key, (3, 4, 4, 4)) * magnitude


def test_elastic_displacement_matches_jax():
    key = jax.random.PRNGKey(4)
    want = jS.random_elastic_displacement(key, SHAPE, magnitude=2.0)
    got = tS.elastic_displacement(_t(_jax_grid(key)), SHAPE)
    assert got.shape == (3,) + SHAPE
    _close(got, want, 1e-5)


def test_random_elastic_displacement_is_its_grid_resized():
    """The random field is the cubic resize of its coarse draw, whose
    spread is the magnitude."""
    got = tS.random_elastic_displacement(torch.Generator().manual_seed(2),
                                         SHAPE, magnitude=3.0)
    grid = tS.draw_elastic_grid(torch.Generator().manual_seed(2), 3,
                                magnitude=3.0)
    np.testing.assert_array_equal(
        got.numpy(), tS.elastic_displacement(grid, SHAPE).numpy())
    grids = tS.draw_elastic_grid(torch.Generator().manual_seed(3), 3, 40,
                                 magnitude=3.0)
    assert abs(float(grids.std()) - 3.0) < 0.05


def _matrix(seed):
    rng = np.random.default_rng(seed)
    m = np.asarray(jS.random_affine_matrix(
        jax.random.PRNGKey(seed), SHAPE, rotate_range=0.3, scale_range=0.1,
        shear_range=0.1, translate_range=0.05))
    return m.astype(np.float32), rng


def _near_half(coords, tol=1e-4):
    frac = np.abs(np.asarray(coords) - np.floor(np.asarray(coords)) - 0.5)
    return (frac < tol).any(axis=0)


def _check_labels(got, want, coords):
    """Equal except voxels sampled within 1e-4 of a half-integer, which
    must be at most 0.1 % of them."""
    got, want = np.asarray(got), np.asarray(want)
    diff = got != want
    near = _near_half(coords).reshape(diff.shape[:3])
    if diff.ndim == 4:
        diff = diff.any(-1)
    assert not (diff & ~near).any()
    assert diff.sum() <= 1e-3 * diff.size


@pytest.mark.parametrize("seed", [0, 1])
def test_warp_with_displacement_matches_jax(seed):
    vol = _vol(seed)
    label = np.round(_vol(seed + 10, SHAPE + (1,)) * 3)
    m, _ = _matrix(seed)
    key = jax.random.PRNGKey(seed + 20)
    disp = jS.random_elastic_displacement(key, SHAPE, magnitude=2.0)
    tdisp = tS.elastic_displacement(_t(_jax_grid(key)), SHAPE)
    want = jS.warp_affine(jnp.asarray(vol), jnp.asarray(m),
                          displacement=disp)
    got = tS.warp_affine(_t(vol), _t(m), displacement=tdisp)
    _close(got, want)
    want_l = jS.warp_affine(jnp.asarray(label), jnp.asarray(m),
                            method="nearest", displacement=disp)
    got_l = tS.warp_affine(_t(label), _t(m), method="nearest",
                           displacement=tdisp)
    coords = np.asarray(jS.affine_coords(jnp.asarray(m), SHAPE) + disp)
    _check_labels(got_l, want_l, coords)


# -- intensity ops ------------------------------------------------------------


def _uni(key, lo, hi):
    return float(jax.random.uniform(key, (), minval=lo, maxval=hi))


def _intensity_cases():
    """(name, JAX call, port call) with JAX's draws handed to the port."""
    k = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(k)
    return [
        ("scale_intensity", lambda x: jI.scale_intensity(x, -1.0, 2.0),
         lambda x: tI.scale_intensity(x, -1.0, 2.0)),
        ("conditional_rescale",
         lambda x: jI.conditional_rescale(x, 0.5, -2 / 3),
         lambda x: tI.conditional_rescale(x, 0.5, -2 / 3)),
        ("conditional_rescale_off",
         lambda x: jI.conditional_rescale(x, 5.0, -2 / 3),
         lambda x: tI.conditional_rescale(x, 5.0, -2 / 3)),
        ("offset_intensity", jI.offset_intensity, tI.offset_intensity),
        ("offset_given", lambda x: jI.offset_intensity(x, 0.25),
         lambda x: tI.offset_intensity(x, 0.25)),
        ("normalize", jI.normalize, tI.normalize),
        ("scale_intensity_along_dim", jI.scale_intensity_along_dim,
         tI.scale_intensity_along_dim),
        ("gaussian_noise", lambda x: jI.gaussian_noise(k, x, 0.3),
         lambda x: tI.gaussian_noise(
             None, x, 0.3, noise=_t(jax.random.normal(k, x.shape)))),
        ("rician_noise", lambda x: jI.rician_noise(k, x, 0.2),
         lambda x: tI.rician(x, _t(jax.random.normal(k1, x.shape)),
                             _t(jax.random.normal(k2, x.shape)), 0.2)),
        ("gibbs_ringing", lambda x: jI.gibbs_ringing(k, x, (0.4, 0.7)),
         lambda x: tI.truncate_kspace(x, _uni(k, 0.4, 0.7))),
        ("bias_field", lambda x: jI.bias_field(k, x),
         lambda x: tI.apply_bias_field(
             x, _t(jax.random.normal(k, (4, 4, 4, 1)) * 0.3))),
        ("adjust_contrast", lambda x: jI.adjust_contrast(k, x),
         lambda x: tI.contrast_gamma(x, torch.tensor(_uni(k, 0.7, 1.5)))),
        ("gaussian_smooth", lambda x: jI.gaussian_smooth(x, 1.3),
         lambda x: tI.gaussian_smooth(x, 1.3)),
        ("gaussian_smooth_sigma0", lambda x: jI.gaussian_smooth(x, 0.0),
         lambda x: tI.gaussian_smooth(x, 0.0)),
        ("random_gaussian_smooth",
         lambda x: jI.random_gaussian_smooth(k, x, (0.25, 1.5)),
         lambda x: tI.gaussian_smooth(x, torch.tensor(_uni(k, 0.25, 1.5)))),
        ("sharpen", lambda x: jI.sharpen(x, 0.7, 1.2),
         lambda x: tI.sharpen(x, 0.7, 1.2)),
        ("histogram_shift", lambda x: jI.histogram_shift(k, x),
         lambda x: tI.histogram_remap(x, _t(jax.random.uniform(k, (10,))))),
        ("low_resolution", lambda x: jI.low_resolution(k, x, (0.5, 1.0)),
         lambda x: tI.low_resolution_at(x, _uni(k, 0.5, 1.0))),
        ("low_resolution_zoom_up",
         lambda x: jI.low_resolution(k, x, (1.0, 1.2)),
         lambda x: tI.low_resolution_at(x, _uni(k, 1.0, 1.2))),
        ("salt_and_pepper", lambda x: jI.salt_and_pepper(k, x, 0.1),
         lambda x: tI.salt_and_pepper_at(
             x, _t(jax.random.uniform(k1, x.shape)), 0.1)),
    ]


@pytest.mark.parametrize("case", _intensity_cases(), ids=lambda c: c[0])
def test_intensity_op_matches_jax(case):
    _, jfn, tfn = case
    x = _vol(5)
    want = jfn(jnp.asarray(x))
    got = tfn(_t(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, want)


def test_gaussian_kernel_matches_jax():
    """Within two f32 ulps of 1 (the two libraries' exp differ in the last
    bit)."""
    for sigma in (0.0, 0.3, 1.0, 2.7):
        _close(tI._gaussian_kernel1d(torch.tensor(sigma), 3),
               jI._gaussian_kernel1d(jnp.asarray(sigma), 3), 2.4e-7)


@pytest.mark.parametrize("op", ["bias_field", "gaussian_smooth",
                                "gibbs_ringing", "low_resolution"])
def test_intensity_ops_keep_bf16(op):
    x = _t(_vol(6)).to(torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    fn = {"bias_field": lambda: tI.bias_field(g, x),
          "gaussian_smooth": lambda: tI.gaussian_smooth(x, 1.0),
          "gibbs_ringing": lambda: tI.gibbs_ringing(g, x),
          "low_resolution": lambda: tI.low_resolution(g, x)}[op]
    out = fn()
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()


# -- TrivialAugment -----------------------------------------------------------


def test_workhorse_names_match_jax():
    got = tA.AugmentationWorkhorse(ndim=3).names
    want = jA.AugmentationWorkhorse(ndim=3).names
    assert got == want and len(got) == 27
    assert got[:9] == ["gaussian_noise", "shift_intensity",
                       "scale_intensity", "contrast", "coarse_dropout",
                       "rbf", "gibbs_noise", "spike_noise", "rician_noise"]
    assert got[9:15] == [f"{k}_x" for k in (
        "gaussian_smooth", "gaussian_sharpen", "rotate", "translate",
        "shear", "scale")]
    assert tA.generic_augments == jA.generic_augments
    assert tA.mri_specific_augments == jA.mri_specific_augments
    assert tA.spatial_augments == jA.spatial_augments
    assert list(tA.build_registry(2)) == list(jA.build_registry(2))


def jax_op_draws(name, key, shape):
    """The draws a JAX registry op makes from ``key`` for a volume of
    ``shape``, as the port's cores take them."""
    ndim = len(shape) - 1
    if name in ("gaussian_noise",):
        return (jax.random.normal(key, shape),)
    if name in ("shift_intensity", "scale_intensity", "contrast",
                "gibbs_noise"):
        return (jax.random.uniform(key, ()),)
    if name == "coarse_dropout":
        return (jax.random.uniform(key, (8,) * ndim + (1,)),)
    if name == "rbf":
        return (jax.random.normal(key, (4,) * ndim + (1,)),)
    if name == "spike_noise":
        pos_key, _ = jax.random.split(key)
        return (jnp.stack([
            jax.random.randint(jax.random.fold_in(pos_key, d), (), 0,
                               shape[d]) for d in range(ndim)]),)
    if name == "rician_noise":
        k1, k2 = jax.random.split(key)
        return (jax.random.normal(k1, shape), jax.random.normal(k2, shape))
    if name.startswith(("gaussian_smooth", "gaussian_sharpen")):
        return ()
    return (jax.random.bernoulli(key),)


def _to_torch_draws(draws):
    return tuple(_t(d) for d in draws)


@pytest.mark.parametrize("mag", [0.25, 1.0])
@pytest.mark.parametrize("name", jA.AugmentationWorkhorse(ndim=3).names)
def test_workhorse_op_matches_jax(name, mag):
    x = _vol(7)
    key = jax.random.PRNGKey(11)
    want = jA.build_registry(3)[name](key, jnp.asarray(x),
                                      jnp.float32(mag))
    op = tA.build_registry(3)[name]
    got = op.core(_t(x), torch.tensor(mag),
                  *_to_torch_draws(jax_op_draws(name, key, x.shape)))
    assert got.dtype == torch.float32 and got.shape == x.shape
    tol = 1e-4 * float(np.abs(np.asarray(want)).max()) \
        if name == "spike_noise" else TOL
    _close(got, want, tol)


@pytest.mark.parametrize("name", tA.AugmentationWorkhorse(ndim=3).names)
def test_workhorse_op_draws_and_keeps_bf16(name):
    x = _t(_vol(8)).to(torch.bfloat16)
    op = tA.build_registry(3)[name]
    g = torch.Generator().manual_seed(1)
    out = op.core(x, torch.tensor(0.5), *op.draw(g, x))
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    assert torch.isfinite(out).all()


def test_workhorse_choice_and_magnitude_statistics():
    """The op index is uniform over the 27 ops (from the host generator
    seeded with ``seed``, so two workhorses of one seed agree), the
    magnitude uniform in [0, 1)."""
    x = torch.zeros(4, 4, 2, 1)
    wh = tA.AugmentationWorkhorse(ndim=3, seed=5)
    g = torch.Generator().manual_seed(0)
    picks = [wh.draw(g, x)[0] for _ in range(2700)]
    counts = np.bincount([p[0] for p in picks], minlength=27)
    assert counts.min() > 60 and counts.max() < 140  # 100 expected
    mags = np.array([float(p[1]) for p in picks])
    assert 0.0 <= mags.min() and mags.max() < 1.0
    assert abs(mags.mean() - 0.5) < 0.02
    again = tA.AugmentationWorkhorse(ndim=3, seed=5)
    assert [again.draw(g, x)[0][0] for _ in range(50)] == [
        p[0] for p in picks[:50]]


# -- the whole sample --------------------------------------------------------


ALL_FLAGS = list(tpipe.FLAGS)


def _policy(mod, flags, on):
    p = 1.0 if on else 0.0
    return mod.AugmentPolicy.from_flags(
        flags, prob=p, distort_prob=p, lowres_prob=p, blur_prob=p,
        flip_prob=p, scale_range=0.0, flip_axes=(0, 1, 2))


def _jax_draws(key, image, policy, workhorse):
    """The draws of the JAX package's ``_augment_one`` for ``key``, keyed
    as the port's ``draw_augment`` returns them."""
    shape = image.shape[:-1]
    keys = jax.random.split(key, 8)
    d = {}
    fold = policy.flip and (policy.affine or policy.shear)
    if policy.distort:
        d["do_distort"] = jax.random.bernoulli(keys[2], policy.distort_prob)
        d["elastic_grid"] = _jax_grid(keys[3], policy.distort_magnitude)
    if policy.affine or policy.shear or policy.distort:
        do_aff = jax.random.bernoulli(jax.random.fold_in(keys[0], 101),
                                      policy.prob).astype(jnp.float32)
        do_shear = jax.random.bernoulli(jax.random.fold_in(keys[0], 102),
                                        policy.prob).astype(jnp.float32)
        rot = jnp.asarray(policy.rotate_range, jnp.float32)
        scl = jnp.asarray(policy.scale_range, jnp.float32)
        trn = jnp.asarray(policy.translate_range, jnp.float32)
        mat = jS.random_affine_matrix(
            keys[0], shape,
            rotate_range=rot * do_aff if policy.affine else 0.0,
            scale_range=scl * do_aff if policy.affine else 0.0,
            shear_range=policy.shear_range * do_shear if policy.shear
            else 0.0,
            translate_range=trn * do_aff)
        if fold:
            mat = jS.compose_flips(keys[1], mat, shape, policy.flip_axes,
                                   prob=policy.flip_prob)
        d["matrix"] = mat
    if policy.flip and not fold:
        ks = jax.random.split(keys[1], len(policy.flip_axes))
        d["flip_gates"] = jnp.stack(
            [jax.random.bernoulli(k, policy.flip_prob) for k in ks])
    if policy.noise:
        d["do_gibbs"] = jax.random.bernoulli(keys[5], policy.prob)
        d["gibbs_alpha"] = jax.random.uniform(
            jax.random.fold_in(keys[5], 1), (), minval=0.4, maxval=0.7)
    if policy.rbf:
        d["do_rbf"] = jax.random.bernoulli(jax.random.fold_in(keys[6], 1),
                                           policy.prob)
        d["bias_grid"] = jax.random.normal(keys[6], (4, 4, 4, 1)) * 0.3
    if policy.blur:
        d["do_blur"] = jax.random.bernoulli(
            jax.random.fold_in(keys[7], 1), policy.blur_prob)
        d["blur_sigma"] = jax.random.uniform(keys[7], (), minval=0.25,
                                             maxval=1.5)
    if policy.lowres:
        d["do_lowres"] = jax.random.bernoulli(keys[4], policy.lowres_prob)
        d["lowres_zoom"] = jax.random.uniform(
            jax.random.fold_in(keys[4], 3), (), minval=0.8, maxval=1.2)
    out = {k: _t(v) for k, v in d.items()}
    if policy.trivial:
        _, k_choice, k_mag, k_op = jax.random.split(
            jax.random.fold_in(keys[7], 11), 4)
        choice = int(jax.random.randint(k_choice, (), 0, 27))
        name = workhorse.names[choice]
        out["trivial"] = [(choice, _t(jax.random.uniform(k_mag)),
                           _to_torch_draws(jax_op_draws(name, k_op,
                                                        image.shape)))]
    return out, d


@pytest.mark.parametrize("on", [True, False])
@pytest.mark.parametrize(
    "flags", [ALL_FLAGS, [f for f in ALL_FLAGS if f not in ("affine",
                                                            "shear")]],
    ids=["all", "distort_without_affine"])
# the workhorse picks scale_z, shift_intensity and gaussian_sharpen_z
@pytest.mark.parametrize("seed", [0, 4, 5])
def test_augment_one_matches_jax(seed, flags, on):
    image = _vol(seed + 30, SHAPE + (1,))
    label = (image[..., 0] > 0.6).astype(np.float32)
    jpol, tpol = _policy(jpipe, flags, on), _policy(tpipe, flags, on)
    jwh = jA.AugmentationWorkhorse(ndim=3)
    twh = tA.AugmentationWorkhorse(ndim=3)
    key = jax.random.PRNGKey(seed)
    draws, jd = _jax_draws(key, image, jpol, jwh)
    want_i, want_l, want_g = jpipe._augment_one(
        key, jnp.asarray(image), jnp.asarray(label), jpol, jwh,
        return_geometry=True)
    got_i, got_l, got_g = tpipe.apply_augment(_t(image), _t(label), tpol,
                                              draws, twh)
    assert got_i.dtype == torch.float32 and got_l.dtype == torch.float32
    _close(got_i, want_i)
    _close(got_g, want_g, 1e-6)
    coords = jS.affine_coords(jd["matrix"], SHAPE)
    if "elastic_grid" in jd:
        coords = coords + jS.random_elastic_displacement(
            jax.random.split(key, 8)[3], SHAPE,
            magnitude=jpol.distort_magnitude) * jd["do_distort"]
    _check_labels(got_l, want_l, coords)


def test_augment_one_keeps_bf16_and_every_gate_fires():
    image = _t(_vol(40, SHAPE + (1,))).to(torch.bfloat16)
    label = (image[..., 0] > 0.6).float()
    pol = _policy(tpipe, ALL_FLAGS, True)
    g = torch.Generator().manual_seed(3)
    draws = tpipe.draw_augment(g, image, pol,
                               tA.AugmentationWorkhorse(ndim=3))
    assert all(bool(draws[k]) for k in draws if k.startswith("do_"))
    img, lab, geom = tpipe.apply_augment(
        image, label, pol, draws, tA.AugmentationWorkhorse(ndim=3))
    assert img.dtype == torch.bfloat16 and lab.dtype == torch.float32
    assert torch.isfinite(img.float()).all() and geom.shape == (4, 4)


def test_port_draws_follow_their_distributions():
    """Gates fire at their probabilities; the elastic and bias grids are
    normal with the magnitudes' spread; alpha, sigma and zoom stay in
    their ranges."""
    pol = tpipe.AugmentPolicy.from_flags(ALL_FLAGS)
    image = torch.zeros(SHAPE + (1,))
    g = torch.Generator().manual_seed(0)
    draws = [tpipe.draw_augment(g, image, pol) for _ in range(1500)]
    for key, prob in (("do_distort", pol.distort_prob),
                      ("do_gibbs", pol.prob), ("do_rbf", pol.prob),
                      ("do_blur", pol.blur_prob),
                      ("do_lowres", pol.lowres_prob)):
        rate = np.mean([bool(d[key]) for d in draws])
        assert abs(rate - prob) < 0.035, (key, rate)
    grids = torch.stack([d["elastic_grid"] for d in draws])
    assert abs(float(grids.std()) - pol.distort_magnitude) < 0.05
    bias = torch.stack([d["bias_grid"] for d in draws])
    assert abs(float(bias.std()) - 0.3) < 0.01
    for key, (lo, hi) in (("gibbs_alpha", tpipe.GIBBS_ALPHA),
                          ("blur_sigma", tpipe.BLUR_SIGMA),
                          ("lowres_zoom", tpipe.LOWRES_ZOOM)):
        v = np.array([float(d[key]) for d in draws])
        assert lo <= v.min() and v.max() < hi
        assert abs(v.mean() - (lo + hi) / 2) < 0.03 * (hi - lo)


def test_segmentation_augment_with_every_flag_and_crops():
    x = np.random.default_rng(14).uniform(size=(2,) + SHAPE + (1,)).astype(
        np.float32)
    lab = (x[..., 0] > 0.7).astype(np.float32)
    tr = tpipe.SegmentationTransforms(
        augmentations=tpipe.AugmentPolicy.from_flags(
            ALL_FLAGS, prob=1.0, scale_range=0.0, flip_axes=(0, 1, 2)),
        crop_size=(8, 8, 4), seed=3)
    fg = torch.zeros(2, 16, 3, dtype=torch.int32)
    out = tr.augment(torch.Generator().manual_seed(2),
                     {"image": _t(x).to(torch.bfloat16), "label": _t(lab),
                      "fg_indices": fg, "n_fg": torch.zeros(2,
                                                             dtype=torch.int32)})
    assert out["image"].shape == (2, 8, 8, 4, 1)
    assert out["image"].dtype == torch.bfloat16
    assert out["label"].shape == (2, 8, 8, 4)
    assert torch.isfinite(out["image"].float()).all()
    assert tr.workhorse is not None and "seed" not in repr(tr)


def test_augment_policy_fields_match_jax_for_every_flag_set():
    kw = dict(scale_range=0.0, flip_axes=(0, 1, 2))
    for n in range(len(ALL_FLAGS) + 1):
        for flags in itertools.combinations(ALL_FLAGS, n):
            got = dataclasses.asdict(tpipe.AugmentPolicy.from_flags(flags,
                                                                    **kw))
            want = dataclasses.asdict(jpipe.AugmentPolicy.from_flags(flags,
                                                                     **kw))
            assert got == want, flags
    assert list(dataclasses.asdict(tpipe.AugmentPolicy())) == list(
        dataclasses.asdict(jpipe.AugmentPolicy()))
