"""
The port's UNETR against the JAX UNETR, on the CPU.

A small anisotropic UNETR with the structure of ``sample_configs/
unetr.yaml`` at 256x256x64: patch (16, 16, 8) on a 32x32x16 input, so that
each skip ladder overshoots z and ``resize_like`` shrinks it again four
times per forward. Parameters drawn from a seeded numpy generator move into
the port through ``from_flax``; the same numpy input goes through both, in
f32. Tolerances: logits 1e-4 relative to their scale, the training step's
loss and every parameter's gradient 1e-4 relative (dropout 0), two
frameworks summing the same products in different orders.
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
from adell_mri_tpu.config import factories as jfactories
from adell_mri_tpu.config import parsing as jparsing
from adell_mri_tpu.train import steps as jsteps
from adell_mri_torch.config import factories as tfactories
from adell_mri_torch.config import parsing as tparsing
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.layers import multi_resolution as tres
from adell_mri_torch.models.segmentation.unetr import UNETR, tokens_to_volume
from adell_mri_torch.train import steps as tsteps
from test_torch_unet import random_flax_params

# the yaml's keys (the factory's fallbacks resolve them), narrow widths
CONFIG = dict(
    patch_size=[16, 16, 8],
    embedding_size=32,
    number_of_blocks=4,
    n_heads=4,
    feature_size=4,
    norm_type="instance",
    dropout_rate=0.0,
    n_channels=1,
    spatial_dimensions=3,
    # read by neither factory for this net type
    activation_fn="leaky_relu",
    depth=[16, 32, 64, 128],
)
SIZE = (32, 32, 16)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    image = rng.uniform(size=(2,) + SIZE + (1,)).astype(np.float32)
    label = (rng.uniform(size=(2,) + SIZE) > 0.6).astype(np.float32)
    return image, label


def _pair(config, size=SIZE, seed=1):
    image = np.random.default_rng(0).uniform(
        size=(2,) + tuple(size) + (1,)).astype(np.float32)
    jm = jfactories.get_segmentation_network("unetr", config, n_classes=2)
    params = random_flax_params(jm, jnp.asarray(image), seed=seed)
    tm = tfactories.get_segmentation_network(
        "unetr", config, n_classes=2, image_size=size
    )
    state = from_flax(params)
    assert set(state) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert tuple(state[k].shape) == tuple(v.shape), k
    tm.load_state_dict(state)
    return jm, params, tm.eval(), image


@pytest.fixture(scope="module")
def pair():
    return _pair(CONFIG)


def _logits_close(jm, params, tm, image):
    want = np.asarray(
        jm.apply({"params": params}, jnp.asarray(image),
                 return_logits=True)[0]
    )
    with torch.no_grad():
        got = tm(torch.from_numpy(image), return_logits=True).numpy()
    assert got.shape == want.shape == image.shape
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
    return want


def test_unetr_logits_match_jax(pair, monkeypatch):
    jm, params, tm, image = pair
    resizes = []
    real = tres.resize_like
    import adell_mri_torch.models.segmentation.unetr as tunetr

    def counted(x, target, method="linear"):
        resizes.append((tuple(x.shape[1:-1]), tuple(target)))
        return real(x, target, method)

    monkeypatch.setattr(tunetr, "resize_like", counted)
    want = _logits_close(jm, params, tm, image)
    # three skip ladders and dec_3, each halving z only
    assert resizes == [
        ((16, 16, 16), (16, 16, 8)), ((8, 8, 8), (8, 8, 4)),
        ((4, 4, 4), (4, 4, 2)), ((4, 4, 4), (4, 4, 2)),
    ]
    with torch.no_grad():
        prob = tm(torch.from_numpy(image)).numpy()
    np.testing.assert_allclose(prob, 1 / (1 + np.exp(-want)), atol=1e-5)


def test_unetr_module_names_follow_the_jax_tree(pair):
    _, params, tm, _ = pair
    top = set(params)
    assert {"LinearEmbedding_0", "TransformerBlockStack_0", "Conv_0",
            "Conv_1", "bn_proj", "proj_0_0", "proj_0_2", "proj_2_0",
            "dec_0", "dec_3"} <= top
    assert "ConvTranspose_0" in params["dec_3"]
    assert top == {k.split(".")[0] for k in tm.state_dict()}


def test_unetr_isotropic_patch_without_resize():
    """Patch (4, 4, 4) on 16^3: the ladders land on their scales, the
    deepest skips keep the token width (no transposed conv), and the
    decoder's first stage merges a skip far below the bottleneck."""
    config = {**CONFIG, "patch_size": [4, 4, 4], "n_heads": 2}
    _logits_close(*_pair(config, size=(16, 16, 16), seed=2))


def test_unetr_flash_branch_matches_jax(pair, monkeypatch):
    """The same model with both sides on their flash branch (8 tokens)."""
    real = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return real(*args, **kwargs)

    monkeypatch.setattr(jattn.pl, "pallas_call", patched)
    monkeypatch.setenv("ADELL_PALLAS_FORCE", "1")
    monkeypatch.setattr(jvit, "FLASH_MIN_TOKENS", 8)
    monkeypatch.setattr(tvit, "FLASH_MIN_TOKENS", 8)
    calls = []
    real_flash = tvit.flash_attention

    def counted(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return real_flash(*args, **kwargs)

    monkeypatch.setattr(tvit, "flash_attention", counted)
    _logits_close(*pair)
    assert calls == [(2, 4, 8, 8)] * 4  # one per block, [B, H, N, Dh]


@pytest.fixture(scope="module")
def step_pair(pair):
    """One training step (the yaml's dice + focal loss, dropout 0) on both
    sides from the same weights and batch."""
    jm, params, tm, _ = pair
    image, label = _batch(3)
    spec = {"dice": {"eps": 1.0e-6}, "focal": {"gamma": 0.0}}
    jlm = jsteps.make_segmentation_step(
        jm, jparsing.build_compound_loss(spec, 2), train=True
    )
    (jloss, _), jgrads = jax.value_and_grad(jlm, has_aux=True)(
        params, {"image": jnp.asarray(image), "label": jnp.asarray(label)},
        jax.random.PRNGKey(0),
    )
    tlm = tsteps.make_segmentation_step(
        tm, tparsing.build_compound_loss(spec, 2), train=True
    )
    tparams = dict(tm.named_parameters())
    tloss, _ = tlm(
        tparams,
        {"image": torch.from_numpy(image), "label": torch.from_numpy(label)},
    )
    names = list(tparams)
    tgrads = torch.autograd.grad(tloss, [tparams[k] for k in names])
    tm.eval()
    return float(jloss), from_flax(jgrads), float(tloss), dict(
        zip(names, tgrads))


def test_unetr_step_loss_matches_jax(step_pair):
    jloss, _, tloss, _ = step_pair
    assert abs(tloss - jloss) <= 1e-4 * abs(jloss)


def test_unetr_step_gradients_match_jax(step_pair):
    _, jg, _, tg = step_pair
    assert set(jg) == set(tg)
    scale = max(float(g.abs().max()) for g in jg.values())
    checked = 0
    for k, want in jg.items():
        got = tg[k].detach()
        assert got.shape == want.shape, k
        own = float(want.abs().max())
        if own < 1e-5 * scale:
            # a conv bias ahead of an instance norm: its gradient is zero,
            # rounding noise on both sides
            assert float(got.abs().max()) < 1e-5 * scale, k
            continue
        checked += 1
        assert float((got - want).abs().max()) <= 1e-4 * own, k
    assert checked > len(jg) // 2


def test_unetr_dropout_is_active_only_in_training(pair):
    _, params, _, image = pair
    tm = tfactories.get_segmentation_network(
        "unetr", {**CONFIG, "dropout_rate": 0.3}, image_size=SIZE
    )
    tm.load_state_dict(from_flax(params))
    x = torch.from_numpy(image)
    with torch.no_grad():
        a, b = tm.eval()(x), tm.eval()(x)
        c = tm.train()(x)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_unetr_bf16_forward_runs(pair):
    _, params, tm, image = pair
    model = UNETR(SIZE, patch_size=(16, 16, 8), embed_dim=32, n_blocks=4,
                  n_heads=4, feature_size=4)
    model.load_state_dict(from_flax(params))
    with torch.no_grad():
        out = model.to(torch.bfloat16).eval()(
            torch.from_numpy(image).bfloat16())
        want = tm(torch.from_numpy(image))
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    assert float((out.float() - want).abs().max()) < 0.1


def test_tokens_to_volume():
    t = torch.arange(2 * 7 * 3).reshape(2, 7, 3)
    v = tokens_to_volume(t, (1, 2, 3), skip_tokens=1)
    assert v.shape == (2, 1, 2, 3, 3)
    assert torch.equal(v.reshape(2, 6, 3), t[:, 1:])


@pytest.mark.parametrize(
    "option",
    [
        {"skip_conditioning": 1},
        {"feature_conditioning": 2},
        {"norm_type": "batch"},
        {"norm_type": "group"},
        {"spatial_dimensions": 2},
    ],
)
def test_unported_unetr_options_raise(option):
    with pytest.raises(NotImplementedError):
        tfactories.get_segmentation_network(
            "unetr", {**CONFIG, **option}, image_size=SIZE
        )


def test_factory_net_types():
    assert isinstance(
        tfactories.get_segmentation_network(
            "monai_unetr", CONFIG, image_size=SIZE), UNETR)
    with pytest.raises(ValueError, match="image_size"):
        tfactories.get_segmentation_network("unetr", CONFIG)
    with pytest.raises(NotImplementedError):
        tfactories.get_segmentation_network("unetpp", CONFIG,
                                            image_size=SIZE)
    with pytest.raises(ValueError, match="built for"):
        UNETR(SIZE)(torch.zeros((1, 16, 16, 16, 1)))
