"""
The port's self-supervised pieces against the JAX package's, on the CPU.

The losses and their gradients, the block masking (exactly, given the JAX
draws, and statistically), ``NonContrastiveWrapper`` over a tiny CatNet
with ``sample_configs/ssl-resnet.yaml``'s pooling, ``IJEPA`` given the
mask JAX drew, ``SSLTransforms`` given the JAX draws, and the decay mask
(``wd_mask``): seeded numpy inputs and parameters
(``random_flax_params``' draw) moved into the port through ``from_flax``.

Tolerances, each stated where it is used: the losses 1e-6 relative and
their gradients 1e-5 of their scale; forwards 1e-5 of the output scale;
views 1e-5. The train steps are held in ``tests/test_torch_ssl_steps.py``.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.config import factories as jfactories
from adell_mri_tpu.config.parsing import parse_config_ssl as jparse_ssl
from adell_mri_tpu.models.ssl import losses as jlosses
from adell_mri_tpu.models.ssl import masking as jmasking
from adell_mri_tpu.train import optim as joptim
from adell_mri_tpu.transforms import augment as jA
from adell_mri_tpu.transforms import pipeline as jpipe
from adell_mri_torch.config import factories as tfactories
from adell_mri_torch.config.parsing import parse_config_ssl
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.layers.adn import pop_batch_stats
from adell_mri_torch.models.ssl import losses as tlosses
from adell_mri_torch.models.ssl import masking as tmasking
from adell_mri_torch.train import optim as toptim
from adell_mri_torch.transforms import pipeline as tpipe
from test_torch_augment_full import jax_op_draws
from test_torch_unet import random_flax_params

YAML = (Path(__file__).resolve().parents[1] / "sample_configs"
        / "ssl-resnet.yaml")
# ssl-resnet.yaml's nesting and pooling at widths 8 and 16
TINY = {
    "backbone_args": {
        "spatial_dim": 3, "in_channels": 1,
        "structure": [[8, 8, 3, 1], [16, 16, 3, 1], [16, 16, 3, 1],
                      [16, 16, 3, 1]],
        "maxpool_structure": [[2, 2, 1], [2, 2, 1], [2, 2, 2], [2, 2, 2]],
        "res_type": "resnet"},
    "projection_head_args": {"structure": [32, 16]},
    "prediction_head_args": {"structure": [24, 16]},
    "norm_fn": "batch",
}
VIEW = (32, 32, 16)
IJEPA_CFG = {"patch_size": [4, 4, 4], "embed_dim": 32, "n_blocks": 2,
             "n_heads": 2, "predictor_dim": 16, "predictor_blocks": 1}
IJEPA_SHAPE = (16, 16, 8)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, tol):
    got = np.asarray(torch.as_tensor(got).detach().float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, tol * scale)


# -- losses -------------------------------------------------------------------


def _pair(seed, n=8, d=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


LOSSES = {
    "simsiam": (jlosses.simsiam_loss, tlosses.simsiam_loss),
    "byol": (jlosses.byol_loss, tlosses.byol_loss),
    "vicreg": (lambda a, b: jlosses.vicreg_loss(a, b)[0],
               lambda a, b: tlosses.vicreg_loss(a, b)[0]),
    "barlow_twins": (jlosses.barlow_twins_loss, tlosses.barlow_twins_loss),
    "ntxent": (jlosses.ntxent_loss, tlosses.ntxent_loss),
    "ntxent_t05": (
        lambda a, b: jlosses.ntxent_loss(a, b, 0.5, apply_relu=False),
        lambda a, b: tlosses.ntxent_loss(a, b, 0.5, apply_relu=False)),
    "ijepa": (jlosses.ijepa_loss, tlosses.ijepa_loss),
    "cosine": (lambda a, b: jnp.sum(jlosses.cosine_similarity(a, b)),
               lambda a, b: torch.sum(tlosses.cosine_similarity(a, b))),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_gradient_match_jax(name):
    """Each loss (1e-6 relative) and its gradient with respect to both
    sides (1e-5 of the gradient's scale; a detached target gets none)."""
    jfn, tfn = LOSSES[name]
    a, b = _pair(3)
    want, (ga, gb) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    got = tfn(ta, tb)
    assert abs(float(got) - float(want)) <= 1e-6 * max(abs(float(want)), 1e-6)
    da, db = torch.autograd.grad(got, [ta, tb], allow_unused=True)
    _close(da, ga, 1e-5)
    if db is None:
        assert float(np.abs(np.asarray(gb)).max()) == 0.0
    else:
        _close(db, gb, 1e-5)


def test_vicreg_components_and_masked_ijepa_match_jax():
    a, b = _pair(4, n=6, d=12)
    _, want = jlosses.vicreg_loss(jnp.asarray(a), jnp.asarray(b))
    _, got = tlosses.vicreg_loss(_t(a), _t(b))
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-6 * max(abs(float(v)), 1e-6)
    rng = np.random.default_rng(5)
    p, q = (rng.normal(size=(2, 10, 4)).astype(np.float32) for _ in range(2))
    mask = (rng.uniform(size=(2, 10)) < 0.4).astype(np.float32)
    want = jlosses.ijepa_loss(jnp.asarray(p), jnp.asarray(q),
                              jnp.asarray(mask))
    got = tlosses.ijepa_loss(_t(p), _t(q), _t(mask))
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


def test_barlow_twins_uses_the_biased_std():
    a, b = _pair(6, n=5, d=4)
    biased = tlosses.barlow_twins_loss(_t(a), _t(b))
    want = jlosses.barlow_twins_loss(jnp.asarray(a), jnp.asarray(b))
    assert abs(float(biased) - float(want)) <= 1e-6 * abs(float(want))
    # the unbiased std would standardise by sqrt(n / (n - 1)) more
    z = _t(a)
    assert not torch.allclose(z.std(0), z.std(0, correction=0))


# -- block masking ------------------------------------------------------------


def _jax_mask_draws(key, n_blocks, ndim):
    keys = jax.random.split(key, n_blocks * 2)
    size = np.stack([np.asarray(jax.random.uniform(keys[2 * i], (ndim,)))
                     for i in range(n_blocks)])
    start = np.stack([np.asarray(jax.random.uniform(keys[2 * i + 1],
                                                    (ndim,)))
                      for i in range(n_blocks)])
    return _t(size), _t(start)


@pytest.mark.parametrize("grid", [(4, 4, 2), (32, 32, 8), (7, 5, 3)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_mask_matches_jax_given_its_draws(grid, seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jmasking.block_masking(key, grid))
    got = tmasking.block_mask(grid, *_jax_mask_draws(key, 4, len(grid)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_block_masking_statistics():
    """Drawn from a generator: values in {0, 1}; each block a box whose
    extents lie within the scale range (``grid * f``, ``f`` between
    0.1 ** (1/3) and 0.25 ** (1/3), at least 1) inside the grid; the mask
    their union; two generators of one seed agree."""
    grid = (32, 32, 8)
    lo, hi = 0.1 ** (1 / 3), 0.25 ** (1 / 3)
    g = torch.Generator().manual_seed(0)
    shares = []
    for _ in range(200):
        size_u, start_u = tmasking.draw_block_masks(g, 4, 3)
        mask = tmasking.block_mask(grid, size_u, start_u).reshape(grid)
        assert set(np.unique(mask.numpy())) <= {0.0, 1.0}
        union = torch.zeros(grid, dtype=torch.bool)
        for i in range(4):
            frac = size_u[i] * (hi - lo) + lo
            sizes = [max(int(n * f), 1) for n, f in zip(grid, frac.tolist())]
            starts = [int(u * (n - s)) for u, n, s in
                      zip(start_u[i].tolist(), grid, sizes)]
            for n, s, st in zip(grid, sizes, starts):
                assert int(n * lo) <= s <= int(n * hi) + 1 and 0 <= st <= n - s
            box = tuple(slice(st, st + s) for st, s in zip(starts, sizes))
            assert bool(mask[box].all())
            union[box] = True
        assert torch.equal(union.float(), mask)
        shares.append(float(mask.mean()))
    # 4 blocks of 10-25 % each, overlapping
    assert 0.1 <= min(shares) and max(shares) <= 1.0
    assert 0.25 < np.mean(shares) < 0.65
    a = tmasking.block_masking(torch.Generator().manual_seed(9), grid)
    b = tmasking.block_masking(torch.Generator().manual_seed(9), grid)
    assert torch.equal(a, b)


# -- networks -----------------------------------------------------------------


def _views(seed, b=4, shape=VIEW):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(b,) + shape + (1,)).astype(np.float32)
            for _ in range(2)]


@functools.lru_cache(maxsize=None)
def _jax_wrapper(seed=0):
    """The JAX wrapper, its parameters and the running statistics of two
    training forwards from (0, 1)."""
    jm = jfactories.get_ssl_network("vicreg", TINY)
    x = jnp.asarray(_views(seed + 1)[0])
    params = random_flax_params(jm, x, seed=seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    bs = jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.full(s.shape, float(path[-1].key == "var"),
                                 s.dtype), shapes["batch_stats"])
    forward = jax.jit(lambda p, b: jm.apply(
        {"params": p, "batch_stats": b}, x, train=True,
        mutable=["batch_stats"])[1]["batch_stats"])
    for _ in range(2):
        bs = forward(params, bs)
    return jm, params, bs


def _wrapper(seed=0):
    """``_jax_wrapper`` and the port's copy."""
    jm, params, bs = _jax_wrapper(seed)
    tm = tfactories.get_ssl_network("vicreg", TINY)
    tm.load_state_dict(from_flax(params, bs))
    return jm, params, bs, tm


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("ret", ["prediction", "projection",
                                 "representation"])
def test_wrapper_matches_jax(ret, train):
    """Each ``ret``, in training (batch statistics; the updated running
    statistics too) and in eval (running statistics): 1e-5 of the output
    scale."""
    jm, params, bs, tm = _wrapper(0)
    x = _views(7, b=2)[0]
    tm.train(train)
    got = tm(_t(x), ret=ret)
    if train:
        want, upd = jm.apply({"params": params, "batch_stats": bs},
                             jnp.asarray(x), train=True, ret=ret,
                             mutable=["batch_stats"])
        stats = from_flax({}, upd["batch_stats"])
        new = pop_batch_stats(tm)
        assert set(new) == set(stats)
        for k, v in stats.items():
            _close(new[k], v, 1e-5)
    else:
        want = jm.apply({"params": params, "batch_stats": bs},
                        jnp.asarray(x), train=False, ret=ret)
    _close(got, want, 1e-5)


def test_wrapper_refuses_local_features():
    """VICRegL's ``ret="local"`` is served (the pair of the normed
    projection and the map of projections; held against JAX in
    ``tests/test_torch_ssl_methods.py``); a ``ret`` the wrapper does not
    know is refused."""
    tm = _wrapper(0)[3]
    proj, local = tm(torch.zeros((1,) + VIEW + (1,)), ret="local")
    assert proj.shape == (1, 16) and local.shape[0] == 1 and (
        local.shape[-1] == 16 and local.dim() == 5)
    with pytest.raises(ValueError, match="ret must be one of"):
        tm(torch.zeros((1,) + VIEW + (1,)), ret="global")


def test_factory_reads_the_yaml_and_refuses_other_methods():
    cfg = parse_config_ssl(str(YAML))["network"]
    assert cfg == jparse_ssl(str(YAML))["network"]
    tm = tfactories.get_ssl_network("byol", cfg)
    names = dict(tm.named_parameters())
    assert names["proj_0.weight"].shape == (1024, 512)
    assert names["pred_1.weight"].shape == (256, 512)
    assert tm.backbone.n_features == 512
    # the four methods added since are built (tests/test_torch_ssl_methods
    # .py); an unknown method is refused
    for method in ("swav", "moco"):
        with pytest.raises(ValueError, match="unknown ssl_method"):
            tfactories.get_ssl_network(method, cfg)


@functools.lru_cache(maxsize=None)
def _jax_ijepa(seed=0):
    jm = jfactories.get_ssl_network("ijepa", IJEPA_CFG)
    x = np.random.default_rng(seed + 1).uniform(
        size=(2,) + IJEPA_SHAPE + (1,)).astype(np.float32)
    shapes = jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0),
                         "masking": jax.random.PRNGKey(1)},
                        jnp.asarray(x), rng=jax.random.PRNGKey(0)))["params"]
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 0.3 if len(s.shape) == 1 else 1.0 / np.sqrt(
            np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) * scale).astype(np.float32)

    return jm, jax.tree.map(draw, shapes), x


def _ijepa(seed=0):
    """``_jax_ijepa`` and the port's copy."""
    jm, params, x = _jax_ijepa(seed)
    tm = tfactories.get_ssl_network("ijepa", IJEPA_CFG,
                                    image_size=IJEPA_SHAPE)
    tm.load_state_dict(from_flax(params))
    return jm, params, tm, x


def test_ijepa_matches_jax_given_its_mask():
    """The prediction and the target features given the mask JAX drew
    (1e-5 of each output's scale); the mask it returns is that mask."""
    jm, params, tm, x = _ijepa(0)
    key = jax.random.PRNGKey(4)
    pred, tgt, mask = jm.apply({"params": params}, jnp.asarray(x), rng=key,
                               train=True)
    grid = [s // 4 for s in IJEPA_SHAPE]
    jmask = np.asarray(jmasking.block_masking(key, grid))
    assert 0 < jmask.sum() < jmask.size
    tm.train()
    got_p, got_t, got_m = tm(_t(x), mask=_t(jmask))
    _close(got_p, pred, 1e-5)
    _close(got_t, tgt, 1e-5)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(mask))
    want = jm.apply({"params": params}, jnp.asarray(x),
                    method=type(jm).encode_target)
    _close(tm.encode_target(_t(x)), want, 1e-5)


def _jax_names(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", p)) for p in path): v
            for path, v in flat}


@pytest.mark.parametrize("net", ["wrapper", "ijepa"])
def test_decay_mask_matches_jax(net):
    """The leaves the port decays are those JAX's ``wd_mask`` decays, by
    the port's name of each JAX leaf."""
    if net == "wrapper":
        _, params, _, tm = _wrapper(0)
    else:
        _, params, tm, _ = _ijepa(0)
    jmask = _jax_names(joptim.wd_mask(params))
    want = {}
    for name, flag in jmask.items():
        key = next(iter(from_flax(_unflatten({name: np.zeros((2, 2))}))))
        want[key] = bool(flag)
    got = toptim.wd_mask(tm)
    assert got == want
    assert any(got.values()) and not all(got.values())


def _unflatten(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# -- transforms ---------------------------------------------------------------


# the JAX workhorse's registry, cut to three ops (an intensity op, a
# rotation and a smoothing) so that its switch compiles in seconds; every
# op of the full registry is held to JAX by tests/test_torch_augment_full.py
VIEW_OPS = ("scale_intensity", "rotate_z", "gaussian_smooth_x")


def _jax_view_draws(key, image, workhorse, n_transforms=3):
    """The JAX package's draws of one view of one sample, keyed as the
    port's ``draw_view`` returns them (op indices into the port's full
    registry)."""
    names = tpipe.AugmentationWorkhorse(ndim=3).names
    k1, k2 = jax.random.split(key)
    picks = []
    for _ in range(n_transforms):
        k1, k_choice, k_mag, k_op = jax.random.split(k1, 4)
        name = workhorse.names[int(jax.random.randint(
            k_choice, (), 0, len(workhorse.names)))]
        picks.append((names.index(name), _t(jax.random.uniform(k_mag)),
                      tuple(torch.from_numpy(np.array(d)) for d in
                            jax_op_draws(name, k_op, image.shape))))
    kz, kt = jax.random.split(k2)
    crop = (_t(jax.random.uniform(kz)),
            _t(jax.random.uniform(kt, (image.ndim - 1,))))
    return picks, crop


@pytest.mark.parametrize("seed", [0, 1])
def test_ssl_views_match_jax_given_its_draws(seed, monkeypatch):
    """Both views of both samples: the workhorse's three ops and the
    scaled crop at its position, given the JAX draws (1e-5 of the view's
    scale), the JAX workhorse's registry cut to ``VIEW_OPS``."""
    monkeypatch.setattr(
        jpipe, "AugmentationWorkhorse",
        lambda augmentations=None, n_transforms=1, ndim=3:
        jA.AugmentationWorkhorse(list(VIEW_OPS), n_transforms, ndim))
    shape, crop = (16, 16, 8), (12, 12, 6)
    images = np.random.default_rng(seed).uniform(
        size=(2,) + shape + (1,)).astype(np.float32)
    jt = jpipe.SSLTransforms(crop_size=crop)
    key = jax.random.PRNGKey(seed)
    out = jt.augment(key, {"image": jnp.asarray(images)})
    tt = tpipe.SSLTransforms(crop_size=crop)
    jwh = jpipe.AugmentationWorkhorse(n_transforms=3, ndim=3)
    k1, k2, _ = jax.random.split(key, 3)
    for name, k in (("view1", k1), ("view2", k2)):
        for i, ki in enumerate(jax.random.split(k, 2)):
            picks, draws = _jax_view_draws(ki, images[i], jwh)
            _close(tt.view(_t(images[i]), picks, draws), out[name][i],
                   1e-5)
    assert np.array_equal(np.asarray(out["image"]), images)


def test_ssl_views_on_the_port_and_refusals():
    tt = tpipe.SSLTransforms(crop_size=(12, 12, 6))
    batch = {"image": torch.rand(3, 16, 16, 8, 1)}
    out = tt.augment(torch.Generator().manual_seed(0), batch)
    assert out["view1"].shape == out["view2"].shape == (3, 12, 12, 6, 1)
    assert out["image"] is batch["image"]
    assert not torch.equal(out["view1"], out["view2"])
    assert torch.isfinite(out["view1"]).all()
    for kw in (dict(slice_2d=True), dict(sample_channels=2)):
        with pytest.raises(NotImplementedError, match="not ported"):
            tpipe.SSLTransforms(**kw)
    # VICRegL's matrices and DINO's local crops are served
    boxes = tpipe.SSLTransforms(crop_size=(12, 12, 6), expose_boxes=True,
                                n_local_crops=2).augment(
        torch.Generator().manual_seed(0), batch)
    assert boxes["view1_mat"].shape == (3, 4, 4)
    assert boxes["local_crops"].shape == (3, 2, 6, 6, 3, 1)
