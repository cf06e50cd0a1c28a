"""
The port's VICRegL, DINO, iBOT and MAE pieces against the JAX package's,
on the CPU.

``DINOHead``, ``DINO`` at two crop sizes with one set of parameters,
``IBOT`` given the masks JAX drew, ``ViTMaskedAutoEncoder`` and
``random_masking`` given JAX's noise, the wrapper's ``ret="local"``, every
loss the port adds (VICRegL with tied distances among them), and
``SSLTransforms`` with crop matrices and local crops given the JAX draws:
seeded numpy inputs and parameters moved into the port through
``from_flax``. The sinusoidal positions that now follow the token count
leave every learnt-position model's output bit-equal. The train steps are
held in ``tests/test_torch_ssl_methods_steps.py``.

Tolerances, each stated where it is used: forwards 1e-5 of the output
scale; losses 1e-6 relative and their gradients 1e-5 of their scale;
views and their matrices 1e-5 of their scale; masks exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.config import factories as jfactories
from adell_mri_tpu.models.ssl import losses as jlosses
from adell_mri_tpu.models.ssl import masking as jmasking
from adell_mri_tpu.models.ssl.nets import DINOHead as JaxDINOHead
from adell_mri_tpu.transforms import augment as jA
from adell_mri_tpu.transforms import pipeline as jpipe
from adell_mri_torch.config import factories as tfactories
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.layers import vit as tvit
from adell_mri_torch.models.layers.adn import pop_batch_stats
from adell_mri_torch.models.ssl import losses as tlosses
from adell_mri_torch.models.ssl import masking as tmasking
from adell_mri_torch.models.ssl.nets import DINOHead
from adell_mri_torch.transforms import pipeline as tpipe
from test_torch_augment_full import jax_op_draws
from test_torch_ssl import (
    TINY,
    _close,
    _jax_mask_draws,
    _jax_wrapper,
    _t,
    _views,
    _wrapper,
)

# the ViT methods at a tiny width: 16x16x8 views in 4x4x4 patches give 32
# tokens, 8x8x4 local crops 4
VIT = {"patch_size": [4, 4, 4], "embed_dim": 16, "n_blocks": 2,
       "n_heads": 2, "out_dim": 32, "hidden_dim": 24, "bottleneck_dim": 8,
       "decoder_dim": 8, "decoder_blocks": 1}
VIEW = (16, 16, 8)
LOCAL = (8, 8, 4)
GRID = [s // 4 for s in VIEW]


def _images(seed, b=2, shape=VIEW):
    return np.random.default_rng(seed).uniform(
        size=(b,) + shape + (1,)).astype(np.float32)


def _draw_params(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 0.3 if len(s.shape) == 1 else 1.0 / np.sqrt(
            np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) * scale).astype(np.float32)

    return jax.tree.map(draw, shapes)


@functools.lru_cache(maxsize=None)
def jax_vit(method, seed=0):
    """The JAX network of ``method`` at ``VIT`` and numpy-drawn
    parameters (iBOT's mask token and MAE's too)."""
    jm = jfactories.get_ssl_network(method, VIT)
    x = jnp.asarray(_images(seed))
    rngs = {"params": jax.random.PRNGKey(0),
            "masking": jax.random.PRNGKey(1)}
    kw = {"ibot": dict(mask=True), "mae": dict(rng=jax.random.PRNGKey(0))}
    shapes = jax.eval_shape(
        lambda: jm.init(rngs, x, **kw.get(method, {})))["params"]
    return jm, _draw_params(shapes, seed)


def port_vit(method, seed=0):
    """``jax_vit`` and the port's copy."""
    jm, params = jax_vit(method, seed)
    tm = tfactories.get_ssl_network(method, VIT, image_size=VIEW)
    tm.load_state_dict(from_flax(params))
    return jm, params, tm


# -- networks -----------------------------------------------------------------


@pytest.mark.parametrize("lead", [(4,), (2, 5)])
def test_dino_head_matches_jax(lead):
    """The head on pooled features [B, E] and on tokens [B, N, E] (iBOT):
    1e-5 of the logits' scale."""
    jh = JaxDINOHead(out_dim=32, hidden_dim=24, bottleneck_dim=8)
    x = np.random.default_rng(1).normal(size=lead + (16,)).astype(
        np.float32)
    params = _draw_params(jax.eval_shape(
        jh.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"], 2)
    th = DINOHead(16, out_dim=32, hidden_dim=24, bottleneck_dim=8)
    th.load_state_dict(from_flax(params))
    _close(th(_t(x)), jh.apply({"params": params}, jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("shape", [VIEW, LOCAL, (12, 8, 8)])
def test_dino_serves_every_crop_size_with_one_parameter_set(shape):
    """One DINO, built for the 16x16x8 views, on the views, on the 8x8x4
    local crops and on a third size: each within 1e-5 of the JAX module
    with the same parameters (positions for the input's token count)."""
    jm, params, tm = port_vit("dino")
    x = _images(3, shape=shape)
    _close(tm(_t(x)), jm.apply({"params": params}, jnp.asarray(x)), 1e-5)
    assert tm.embed.sinusoidal.shape[1] == int(np.prod(GRID))


@pytest.mark.parametrize("mask", [True, False])
def test_ibot_matches_jax_given_its_masks(mask):
    """The mean logits and the token logits (1e-5 of their scale), given
    the per-sample block masks JAX drew, which it returns; unmasked, the
    masks are zeros."""
    jm, params, tm = port_vit("ibot")
    x = _images(4)
    jred, jtok, jmasks = jm.apply({"params": params}, jnp.asarray(x),
                                  mask=mask, rng=jax.random.PRNGKey(6))
    masks = _t(jmasks) if mask else None
    red, tok, masks_out = tm(_t(x), mask=mask, masks=masks)
    _close(red, jred, 1e-5)
    _close(tok, jtok, 1e-5)
    np.testing.assert_array_equal(masks_out.numpy(), np.asarray(jmasks))
    if mask:
        assert 0 < float(masks_out.mean()) < 1


def test_ibot_masks_are_jax_block_masks_of_each_sample():
    """Each sample's mask is ``block_mask`` of that sample's draws, the
    JAX function's mask given them; drawn from a generator, the masks of
    two samples differ and two generators of one seed agree."""
    key = jax.random.PRNGKey(8)
    keys = jax.random.split(key, 3)
    want = np.asarray(jax.vmap(
        lambda k: jmasking.block_masking(k, GRID))(keys))
    for i in range(3):
        got = tmasking.block_mask(GRID, *_jax_mask_draws(keys[i], 4, 3))
        np.testing.assert_array_equal(got.numpy(), want[i])
    tm = port_vit("ibot")[2]
    x = torch.zeros((3,) + VIEW + (1,))
    a = tm.draw_masks(x, torch.Generator().manual_seed(2))
    b = tm.draw_masks(x, torch.Generator().manual_seed(2))
    assert a.shape == (3, int(np.prod(GRID))) and torch.equal(a, b)
    assert not torch.equal(a[0], a[1])


def test_mae_matches_jax_given_its_noise():
    """The predicted patches (1e-5 of their scale), the target patches
    (exactly: a reshape) and the mask, given the noise JAX drew."""
    jm, params, tm = port_vit("mae")
    x = _images(5)
    key = jax.random.PRNGKey(9)
    pred, target, mask = jm.apply({"params": params}, jnp.asarray(x),
                                  rng=key)
    noise = jax.random.uniform(key, mask.shape)
    got_p, got_t, got_m = tm(_t(x), noise=_t(noise))
    _close(got_p, pred, 1e-5)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(target))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(mask))


@pytest.mark.parametrize("n, ratio", [(32, 0.75), (7, 0.5), (5, 0.99)])
def test_random_masking_matches_jax(n, ratio):
    """The visible tokens, mask and restoring permutation of JAX's
    ``random_masking`` given its noise (exactly); ``max(1, int(n (1 -
    ratio)))`` kept; drawn from a generator, the same for one seed."""
    key = jax.random.PRNGKey(n)
    tokens = np.random.default_rng(n).normal(size=(3, n, 4)).astype(
        np.float32)
    vis, mask, restore = jmasking.random_masking(key, jnp.asarray(tokens),
                                                 ratio)
    noise = _t(jax.random.uniform(key, (3, n)))
    got = tmasking.random_masking(_t(tokens), ratio, noise=noise)
    for g, w in zip(got, (vis, mask, restore)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape[1] == max(1, int(n * (1 - ratio)))
    a, b = (tmasking.random_masking(
        _t(tokens), ratio, generator=torch.Generator().manual_seed(1))
        for _ in range(2))
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_wrapper_local_features_match_jax():
    """``ret="local"`` in training: the normed projection of the feature
    map's mean and the projection at each position (1e-5 of each output's
    scale), and the batch statistics of the forward the JAX module would
    keep (1e-5)."""
    jm, params, bs = _jax_wrapper(0)
    tm = _wrapper(0)[3]
    x = _views(7, b=2)[0]
    tm.train()
    proj, local = tm(_t(x), ret="local")
    (jproj, jlocal), upd = jm.apply(
        {"params": params, "batch_stats": bs}, jnp.asarray(x), train=True,
        ret="local", mutable=["batch_stats"])
    assert local.dim() == 5 and local.shape[-1] == proj.shape[-1]
    _close(proj, jproj, 1e-5)
    _close(local, jlocal, 1e-5)
    stats = from_flax({}, upd["batch_stats"])
    for k, v in pop_batch_stats(tm).items():
        _close(v, stats[k], 1e-5)


def test_factory_builds_the_four_methods_at_their_defaults():
    """The JAX factory's defaults: DINO and iBOT 192 wide in 4 blocks of 4
    heads with a 4096-prototype head (hidden 512, bottleneck 128) and 4
    mask blocks; MAE's decoder 96 wide in 2 blocks, mask ratio 0.75;
    VICRegL the wrapper without a prediction head, as its JAX tree."""
    dino = tfactories.get_ssl_network("dino", {}, image_size=(96, 96, 24))
    ibot = tfactories.get_ssl_network("ibot", {}, image_size=(96, 96, 24))
    mae = tfactories.get_ssl_network("mae", {})
    for m in (dino, ibot):
        assert m.encoder.n_blocks == 4
        assert m.head.prototypes.shape == (128, 4096)
        assert m.head.Dense_0.weight.shape == (512, 192)
        assert m.embed.sinusoidal.shape == (1, 24 * 24 * 6, 192)
    assert ibot.n_mask_blocks == 4 and ibot.mask_token.shape == (1, 1, 192)
    assert mae.mask_ratio == 0.75 and mae.decoder.n_blocks == 2
    assert mae.enc2dec.weight.shape == (96, 192)
    assert mae.reconstruct.weight.shape == (64, 96)
    jm = jfactories.get_ssl_network("vicregl", TINY)
    shapes = jax.eval_shape(lambda x: jm.init(
        jax.random.PRNGKey(0), x, ret="local"), jnp.asarray(
        _views(1, b=2)[0]))["params"]
    tm = tfactories.get_ssl_network("vicregl", TINY)
    want = from_flax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    assert set(dict(tm.named_parameters())) == set(want)
    assert not any(k.startswith("pred_") for k in want)
    with pytest.raises(ValueError, match="unknown ssl_method"):
        tfactories.get_ssl_network("swav", {})


# -- positions ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["unetr", "vit", "ijepa", "sinusoidal"])
def test_positions_leave_learnt_and_built_size_outputs_bit_equal(
        name, monkeypatch):
    """UNETR, the ViT classifier and I-JEPA (learnt positions) never ask
    for computed positions, and a sinusoidal embedding at its built size
    adds its buffer: each output equal to the bit to the output with the
    positions taken as before (the learnt parameter, or the buffer)."""
    torch.manual_seed(0)
    if name == "unetr":
        from adell_mri_torch.models.segmentation.unetr import UNETR
        model = UNETR((16, 16, 16), patch_size=(8, 8, 8), embed_dim=16,
                      n_blocks=2, n_heads=2, feature_size=4)
        x = torch.rand(1, 16, 16, 16, 1)
    elif name == "vit":
        model = tfactories.get_classification_network(
            "vit", {"patch_size": [4, 4, 2], "embedding_size": 16,
                    "number_of_blocks": 1, "n_heads": 2}, n_classes=2,
            in_channels=1, image_size=(16, 16, 8))
        x = torch.rand(2, 16, 16, 8, 1)
    elif name == "ijepa":
        model = tfactories.get_ssl_network(
            "ijepa", {**VIT, "predictor_dim": 8, "predictor_blocks": 1},
            image_size=VIEW)
        x = torch.rand(2, *VIEW, 1)
    else:
        model = tvit.LinearEmbedding(1, VIEW, (4, 4, 4), embed_dim=16,
                                     embed_method="convolutional",
                                     learnable_embedding=False)
        x = torch.rand(2, *VIEW, 1)
    model.eval()
    kw = {"mask": torch.zeros(int(np.prod(GRID)))} if name == "ijepa" else {}

    def run():
        with torch.no_grad():
            out = model(x, **kw)
        return out[0] if isinstance(out, tuple) else out

    if name == "sinusoidal":
        got = run()
        want = model.Conv_0(x).reshape(2, -1, 16) + model.sinusoidal
        assert torch.equal(got, want)
        return
    got = run()

    def refuse(self, n, device):
        raise AssertionError("computed positions asked for")

    monkeypatch.setattr(tvit.LinearEmbedding, "positions", refuse)
    assert torch.equal(run(), got)


# -- losses -------------------------------------------------------------------


def _feats(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _vicregl_inputs(seed, ties=False):
    """Global projections [6, 8], local features [6, 10, 8] and their
    positions [6, 10, 3]; with ``ties`` the positions lie on a coarse
    integer lattice, so that many nearest distances are equal (and the
    pairs they select differ in their feature error)."""
    rng = np.random.default_rng(seed)
    z1, z2 = _feats(seed, 6, 8), _feats(seed + 1, 6, 8)
    l1, l2 = _feats(seed + 2, 6, 10, 8), _feats(seed + 3, 6, 10, 8)
    if ties:
        c1 = rng.integers(0, 2, size=(6, 10, 3)).astype(np.float32)
        c2 = rng.integers(0, 2, size=(6, 10, 3)).astype(np.float32)
    else:
        c1 = rng.uniform(0, 10, size=(6, 10, 3)).astype(np.float32)
        c2 = rng.uniform(0, 10, size=(6, 10, 3)).astype(np.float32)
    return z1, z2, l1, l2, c1, c2


def _center(seed, k=16):
    return np.random.default_rng(seed).normal(size=(k,)).astype(
        np.float32) * 0.1


LOSSES = {
    "vicregl": (
        lambda *a: jlosses.vicregl_loss(*a)[0],
        lambda *a: tlosses.vicregl_loss(*a)[0],
        lambda: _vicregl_inputs(0), (0, 1, 2, 3)),
    "vicregl_ties": (
        lambda *a: jlosses.vicregl_loss(*a)[0],
        lambda *a: tlosses.vicregl_loss(*a)[0],
        lambda: _vicregl_inputs(1, ties=True), (0, 1, 2, 3)),
    "dino": (
        lambda s, t, c: jlosses.dino_loss(s, t, c)[0],
        lambda s, t, c: tlosses.dino_loss(s, t, c)[0],
        lambda: (_feats(2, 5, 16), _feats(3, 5, 16), _center(4)), (0,)),
    "dino_sinkhorn": (
        lambda s, t, c: jlosses.dino_loss(s, t, c, use_sinkhorn=True)[0],
        lambda s, t, c: tlosses.dino_loss(s, t, c, use_sinkhorn=True)[0],
        lambda: (_feats(5, 5, 16), _feats(6, 5, 16) * 0.1, _center(7)),
        (0,)),
    "sinkhorn_knopp": (
        lambda s: jnp.sum(jlosses.sinkhorn_knopp(s) * jnp.arange(16.0)),
        lambda s: torch.sum(tlosses.sinkhorn_knopp(s) * torch.arange(16.0)),
        lambda: (_feats(8, 5, 16) * 0.1,), (0,)),
    "mae": (
        jlosses.mae_loss, tlosses.mae_loss,
        lambda: (_feats(9, 3, 7, 12), _feats(10, 3, 7, 12),
                 (np.random.default_rng(11).uniform(size=(3, 7)) < 0.6)
                 .astype(np.float32)), (0,)),
    "koleo": (jlosses.koleo_loss, tlosses.koleo_loss,
              lambda: (_feats(12, 6, 8),), (0,)),
    "contrastive_distance": (
        jlosses.contrastive_distance_loss, tlosses.contrastive_distance_loss,
        lambda: (_feats(13, 6, 4), _feats(14, 6, 4) * 0.3,
                 np.array([1, 0, 1, 0, 0, 1], np.float32)), (0, 1)),
    "kl_divergence": (jlosses.kl_divergence_loss, tlosses.kl_divergence_loss,
                      lambda: (_feats(15, 4, 9), _feats(16, 4, 9)), (0, 1)),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_new_loss_and_gradient_match_jax(name):
    """Each loss (1e-6 relative) and its gradient with respect to each
    differentiable input (1e-5 of the gradient's scale; a detached input,
    DINO's teacher, gets none)."""
    jfn, tfn, make, argnums = LOSSES[name]
    args = make()
    want, jgrads = jax.value_and_grad(jfn, argnums=argnums)(
        *map(jnp.asarray, args))
    targs = [_t(a) for a in args]
    for i in argnums:
        targs[i].requires_grad_()
    got = tfn(*targs)
    assert abs(float(got) - float(want)) <= 1e-6 * max(abs(float(want)),
                                                       1e-6)
    grads = torch.autograd.grad(got, [targs[i] for i in argnums])
    for g, w in zip(grads, jgrads):
        _close(g, w, 1e-5)


def test_vicregl_ties_select_the_lower_index():
    """Where nearest distances tie, both packages keep the pairs of the
    lower index: the selection is the first ``top_k`` of a stable sort,
    and a selection that took the tied pairs in another order gives
    another loss (the case bites)."""
    args = _vicregl_inputs(1, ties=True)
    z1, z2, l1, l2, c1, c2 = map(_t, args)
    d = torch.sum((c1[:, :, None] - c2[:, None]) ** 2, -1)
    nn_dist = d.amin(-1)
    # many equal nearest distances within a sample
    assert max(len(v) - len(torch.unique(v)) for v in nn_dist) >= 5
    stable = torch.sort(nn_dist, dim=1, stable=True)[1][:, :4]
    flipped = 9 - torch.sort(nn_dist.flip(1), dim=1, stable=True)[1][:, :4]
    assert not torch.equal(stable, flipped)
    want = float(jlosses.vicregl_loss(*map(jnp.asarray, args))[0])
    got = float(tlosses.vicregl_loss(z1, z2, l1, l2, c1, c2)[0])
    assert abs(got - want) <= 1e-6 * abs(want)
    # JAX's top_k takes the lower index among ties
    _, jidx = jax.lax.top_k(-jnp.asarray(nn_dist.numpy()), 4)
    np.testing.assert_array_equal(np.asarray(jidx), stable.numpy())


def test_dino_loss_centre_matches_jax():
    """The new centre (1e-6 of its scale)."""
    s, t, c = _feats(2, 5, 16), _feats(3, 5, 16), _center(4)
    _, want = jlosses.dino_loss(*map(jnp.asarray, (s, t, c)))
    _, got = tlosses.dino_loss(_t(s), _t(t), _t(c))
    _close(got, want, 1e-6)


# -- transforms ---------------------------------------------------------------


# non-spatial ops of the JAX registry, so that its switch compiles in
# seconds and VICRegL's matrices stay the views' only geometry
BOX_OPS = ("scale_intensity", "gaussian_smooth_x", "shift_intensity")


def _draws(key, image, jwh, port_names, n_transforms=3):
    """The JAX package's draws of one view (or local crop) of one sample,
    keyed as the port's ``draw_view`` returns them (op indices into the
    port workhorse's ``port_names``)."""
    k1, k2 = jax.random.split(key)
    picks = []
    for _ in range(n_transforms):
        k1, k_choice, k_mag, k_op = jax.random.split(k1, 4)
        name = jwh.names[int(jax.random.randint(k_choice, (), 0,
                                                len(jwh.names)))]
        picks.append((port_names.index(name), _t(jax.random.uniform(k_mag)),
                      tuple(torch.from_numpy(np.array(d)) for d in
                            jax_op_draws(name, k_op, image.shape))))
    kz, kt = jax.random.split(k2)
    return picks, (_t(jax.random.uniform(kz)),
                   _t(jax.random.uniform(kt, (image.ndim - 1,))))


@pytest.mark.parametrize("crop", [(12, 12, 6), None])
def test_boxes_and_local_crops_match_jax_given_its_draws(crop, monkeypatch):
    """``expose_boxes`` and ``n_local_crops`` together: both views of both
    samples and their matrices (1e-5 of their scale; the identity without
    a crop), and each local crop (half the view, zoom in [0.3, 0.6)),
    given the JAX draws, the JAX workhorse's registry cut to
    ``BOX_OPS``."""
    monkeypatch.setattr(
        jpipe, "AugmentationWorkhorse",
        lambda augmentations=None, n_transforms=1, ndim=3:
        jA.AugmentationWorkhorse(list(BOX_OPS), n_transforms, ndim))
    images = _images(20, shape=VIEW)
    jt = jpipe.SSLTransforms(crop_size=crop, expose_boxes=True,
                             n_local_crops=2)
    key = jax.random.PRNGKey(3)
    out = jt.augment(key, {"image": jnp.asarray(images)})
    tt = tpipe.SSLTransforms(crop_size=crop, expose_boxes=True,
                             n_local_crops=2)
    names = tt._workhorse(3).names
    assert set(BOX_OPS) <= set(names)
    assert not {"rotate_z", "translate_x"} & set(names)
    jwh = jpipe.AugmentationWorkhorse(n_transforms=3, ndim=3)
    k1, k2, k3 = jax.random.split(key, 3)
    for name, k in (("view1", k1), ("view2", k2)):
        for i, ki in enumerate(jax.random.split(k, 2)):
            picks, draws = _draws(ki, images[i], jwh, names)
            view, mat = tt.view_and_matrix(
                _t(images[i]), picks, None if crop is None else draws)
            _close(view, out[name][i], 1e-5)
            _close(mat, out[f"{name}_mat"][i], 1e-5)
    local = (6, 6, 3) if crop else (8, 8, 4)
    assert out["local_crops"].shape == (2, 2) + local + (1,)
    for c in range(2):
        keys = jax.random.split(jax.random.fold_in(k3, c), 2)
        for i in range(2):
            picks, draws = _draws(keys[i], images[i], jwh, names)
            _close(tt.view(_t(images[i]), picks, draws, local=True),
                   out["local_crops"][i, c], 1e-5)


def test_boxes_and_local_crops_on_the_port():
    """Drawn from a generator: the views, their matrices (zoom on the
    diagonal in [0.6, 1.0]) and the local crops (in [0.3, 0.6]); the
    remaining refusals."""
    tt = tpipe.SSLTransforms(crop_size=(12, 12, 6), expose_boxes=True,
                             n_local_crops=3)
    batch = {"image": torch.rand(2, 16, 16, 8, 1)}
    out = tt.augment(torch.Generator().manual_seed(0), batch)
    assert out["view1"].shape == (2, 12, 12, 6, 1)
    assert out["view1_mat"].shape == out["view2_mat"].shape == (2, 4, 4)
    diag = torch.diagonal(out["view1_mat"][:, :3, :3], dim1=1, dim2=2)
    assert bool(((diag >= 0.6) & (diag < 1.0)).all())
    assert out["local_crops"].shape == (2, 3, 6, 6, 3, 1)
    assert torch.isfinite(out["local_crops"]).all()
    tl = tpipe.SSLTransforms(crop_size=(12, 12, 6), n_local_crops=1)
    picks, crop = tl.draw_view(torch.Generator().manual_seed(1),
                               batch["image"][0], local=True)
    _, mat = tl.view_and_matrix(batch["image"][0], picks, crop, local=True)
    assert 0.3 <= float(mat[0, 0]) < 0.6
    for kw in (dict(slice_2d=True), dict(sample_channels=2)):
        with pytest.raises(NotImplementedError, match="not ported"):
            tpipe.SSLTransforms(**kw)
