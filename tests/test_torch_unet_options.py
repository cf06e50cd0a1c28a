"""
The port's U-Net options against the JAX UNet, on the CPU.

Every ``conv_type`` the port serves (``resnet`` with
``sample_configs/u-net-3d-resnet.yaml``'s keys at a small depth, ``sae``,
``depthwise``, ``convnext``, ``convnextv2``, ``asp``), every
``link_type``, ``upscale_type: upsample`` (linear, nearest, cubic, and a
size whose decoder needs the resize), every norm of ``make_norm``, prelu
and uout: a JAX ``UNet`` at depth (4, 8, 16) (the resnet bottleneck at
(4, 36, 40)) takes a 16x16x8 input at B=2 in f32; its parameters (and
running statistics), drawn from a seeded numpy generator, move into the
port through ``from_flax``. Tolerance: max-abs over the max |logit| below
1e-4 (f32 on both sides; the sums run in other orders). The unit cases
(SAME ``max_pool`` at odd sizes, ``GroupNorm``, ``GRN``, ``LayerScale``,
``UOut`` with injected noise, ``resize_like``, ``ConvNeXtBlock``) hold
1e-5 of their output scale, 0 for the pool.
"""

from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from adell_mri_tpu.models.layers import adn as jadn
from adell_mri_tpu.models.layers import multi_resolution as jmr
from adell_mri_tpu.models.layers import regularization as jreg
from adell_mri_tpu.models.layers.res_blocks import (
    ConvNeXtBlock as JaxConvNeXtBlock,
)
from adell_mri_tpu.models.segmentation.unet import UNet as JaxUNet
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.layers import adn as tadn
from adell_mri_torch.models.layers import regularization as treg
from adell_mri_torch.models.layers.blocks import max_pool
from adell_mri_torch.models.layers.multi_resolution import resize_like
from adell_mri_torch.models.layers.res_blocks import ConvNeXtBlock
from adell_mri_torch.models.segmentation.unet import UNet

ROOT = Path(__file__).resolve().parents[1]
RESNET_YAML = ROOT / "sample_configs" / "u-net-3d-resnet.yaml"
UNET_KEYS = ("spatial_dimensions", "conv_type", "link_type", "upscale_type",
             "norm_type", "interpolation", "dropout_param", "activation_fn",
             "kernel_sizes", "strides")

BASE = dict(
    spatial_dimensions=3,
    conv_type="regular",
    link_type="identity",
    upscale_type="upsample",
    interpolation="linear",
    norm_type="instance",
    activation_fn="swish",
    dropout_param=0.0,
    n_classes=2,
    depth=(4, 8, 16),
    kernel_sizes=(3, 3, 3),
    strides=(2, 2, 2),
)
SHAPE = (2, 16, 16, 8, 1)


def resnet_config(depth=(4, 36, 40)):
    """``u-net-3d-resnet.yaml``'s U-Net keys at three levels of ``depth``
    (36 and 40 reach the bottleneck blocks, inter = in above 32)."""
    cfg = yaml.safe_load(RESNET_YAML.read_text())
    out = {k: cfg[k] for k in UNET_KEYS}
    out.update(depth=tuple(depth), kernel_sizes=tuple(cfg["kernel_sizes"][:3]),
               strides=tuple(cfg["strides"][:3]), n_classes=2)
    return out


def random_variables(module, x, seed=0):
    """``params`` (and ``batch_stats``, when the module has any) of
    ``module`` drawn from numpy: weights at 1/sqrt(fan-in), vectors at 0.3,
    running means at 0.1 and variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 0.3 if len(s.shape) == 1 else 1.0 / np.sqrt(
            np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) * scale).astype(np.float32)

    out = {"params": jax.tree.map(draw, shapes.get("params", {}))}
    if "batch_stats" in shapes:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, s: (
                rng.uniform(0.5, 1.5, s.shape) if path[-1].key == "var"
                else rng.normal(size=s.shape) * 0.1).astype(np.float32),
            shapes["batch_stats"])
    return out


def pair(config, shape=SHAPE, seed=0):
    """The JAX logits of a seeded input and the port's model with the same
    weights, in eval mode."""
    x = np.random.default_rng(seed + 1).normal(size=shape).astype(np.float32)
    jm = JaxUNet(**config)
    variables = random_variables(jm, jnp.asarray(x), seed)
    logits = jax.jit(
        lambda v, a: jm.apply(v, a, return_logits=True)[0]
    )(variables, jnp.asarray(x))
    tm = UNet(**config)
    state = from_flax(variables["params"], variables.get("batch_stats"))
    assert set(state) == set(tm.state_dict())
    for k, v in tm.state_dict().items():
        assert tuple(state[k].shape) == tuple(v.shape), k
    tm.load_state_dict(state)
    return x, np.asarray(logits), tm.eval(), state


def assert_logits_match(config, shape=SHAPE):
    x, want, model, _ = pair(config, shape)
    with torch.no_grad():
        got = model(torch.from_numpy(x), return_logits=True).numpy()
    assert got.shape == want.shape == shape[:-1] + (1,)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


CASES = {
    "resnet": resnet_config(),
    "resnet_small": resnet_config((4, 8, 16)),
    "sae": dict(BASE, conv_type="sae"),
    "depthwise": dict(BASE, conv_type="depthwise"),
    "convnext": dict(BASE, conv_type="convnext"),
    "convnextv2": dict(BASE, conv_type="convnextv2"),
    "asp": dict(BASE, conv_type="asp"),
    "link_identity": dict(BASE, link_type="identity"),
    "link_conv": dict(BASE, link_type="conv"),
    "link_residual": dict(BASE, link_type="residual"),
    "link_attention": dict(BASE, link_type="attention"),
    "upsample_nearest": dict(BASE, interpolation="nearest"),
    "upsample_cubic": dict(BASE, interpolation="cubic"),
    "upsample_bilinear": dict(BASE, interpolation="bilinear"),
    "transpose": dict(BASE, upscale_type="transpose"),
    "norm_batch": dict(BASE, norm_type="batch"),
    "norm_instance_affine": dict(BASE, norm_type="instance_affine"),
    "norm_layer": dict(BASE, norm_type="layer"),
    "norm_group": dict(BASE, norm_type="group", depth=(8, 12, 16)),
    "norm_identity": dict(BASE, norm_type="identity"),
    "norm_none": dict(BASE, norm_type="none"),
    "prelu": dict(BASE, activation_fn="prelu"),
    "uout": dict(BASE, dropout_type="uout", dropout_param=0.1),
    "jax_defaults": dict(spatial_dimensions=3, depth=(4, 8, 16)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_unet_option_logits_match_jax(case):
    assert_logits_match(CASES[case])


@pytest.mark.parametrize("conv_type", ["regular", "resnet", "depthwise",
                                       "asp", "convnext"])
def test_decoder_resize_at_odd_sizes_matches_jax(conv_type):
    """An 18x14x10 input: the strided units halve to 9x7x5 and 5x4x3, so
    the upsampled 10x8x6 is resized to each skip (linear)."""
    assert_logits_match(dict(BASE, conv_type=conv_type), (1, 18, 14, 10, 1))


def test_resnet_yaml_builds_at_full_width():
    """``UNet(**u-net-3d-resnet.yaml)`` builds, and its blocks are the
    JAX ones: plain residual where the input is at most 32 wide, the
    bottleneck above."""
    cfg = yaml.safe_load(RESNET_YAML.read_text())
    model = UNet(**{k: cfg[k] for k in UNET_KEYS}, depth=cfg["depth"])
    block = model.enc_ds_2.ResidualBlock_0
    assert block.bottleneck and block.Conv_0.weight.shape == (64, 64)
    assert not model.enc_ds_1.ResidualBlock_0.bottleneck
    assert model.enc_ds_0.pool == (2, 2, 2)
    assert type(model.dec_0).__name__ == "_ConvUnit"
    assert model.dec_0.conv_type == "regular"


def test_unet_bf16_option_smoke():
    """bf16 forwards of the resnet, convnext and asp nets with batch norm
    and prelu: finite, near the f32 logits."""
    for conv_type in ("resnet", "convnext", "asp"):
        config = dict(BASE, conv_type=conv_type, norm_type="batch",
                      activation_fn="prelu")
        x, want, model, _ = pair(config)
        with torch.no_grad():
            out = model.to(torch.bfloat16)(
                torch.from_numpy(x).bfloat16(), return_logits=True).float()
        assert torch.isfinite(out).all()
        assert float((out - torch.from_numpy(want)).abs().max()) < (
            0.1 * np.abs(want).max())


# -- units ------------------------------------------------------------------------


@pytest.mark.parametrize("size", [(5, 7, 3), (4, 6, 2), (9, 2, 1)])
@pytest.mark.parametrize("window", [2, (3, 2, 1)])
def test_same_max_pool_matches_flax(size, window):
    x = np.random.default_rng(0).normal(size=(2, *size, 3)).astype(
        np.float32)
    w = (window,) * 3 if isinstance(window, int) else window
    want = fnn.max_pool(jnp.asarray(x), window_shape=w, strides=w,
                        padding="SAME")
    got = max_pool(torch.from_numpy(x), window, padding="SAME")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _close(got, want, rel):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("channels", [8, 12, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_jax(channels, dtype):
    x = (np.random.default_rng(channels).normal(size=(2, 4, 5, 3, channels))
         * 3 + 1).astype(np.float32)
    jm = jadn.GroupNorm()
    params = {"scale": np.linspace(0.5, 1.5, channels, dtype=np.float32),
              "bias": np.linspace(-0.2, 0.2, channels, dtype=np.float32)}
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jm.apply({"params": {k: jnp.asarray(v, jdt)
                                for k, v in params.items()}},
                    jnp.asarray(x, jdt))
    tm = tadn.GroupNorm(channels)
    tm.load_state_dict(from_flax(params))
    tdt = getattr(torch, dtype)
    got = tm.to(tdt)(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    # bf16: a few roundings of the normalised value (scale about 2)
    _close(got, np.asarray(want.astype(jnp.float32)),
           1e-5 if dtype == "float32" else 2 * 2.0 ** -7)


def test_grn_and_layer_scale_match_jax():
    x = np.random.default_rng(3).normal(size=(2, 4, 3, 5, 6)).astype(
        np.float32)
    rng = np.random.default_rng(4)
    p = {"gamma": rng.normal(size=6).astype(np.float32),
         "bias": rng.normal(size=6).astype(np.float32)}
    want = jreg.GRN().apply({"params": p}, jnp.asarray(x))
    tm = treg.GRN(6)
    tm.load_state_dict(from_flax(p))
    _close(tm(torch.from_numpy(x)), want, 1e-5)
    p = {"layer_scale": rng.normal(size=6).astype(np.float32)}
    want = jreg.LayerScale().apply({"params": p}, jnp.asarray(x))
    tm = treg.LayerScale(6)
    tm.load_state_dict(from_flax(p))
    _close(tm(torch.from_numpy(x)), want, 1e-6)
    # fresh: GRN is the identity, LayerScale multiplies by 1e-6
    _close(treg.GRN(6)(torch.from_numpy(x)), x, 0)
    _close(treg.LayerScale(6)(torch.from_numpy(x)), x * 1e-6, 1e-6)


def test_uout_with_injected_noise_matches_jax(monkeypatch):
    """The JAX UOut's uniform draw is patched to return a fixed noise; the
    port's ``draw`` returns the same: x * (1 + noise) on both sides. Eval
    is the identity, and the port's own draws lie in (-beta, beta) with
    the uniform's moments."""
    beta = 0.3
    x = np.random.default_rng(5).normal(size=(2, 6, 5, 4, 3)).astype(
        np.float32)
    noise = np.random.default_rng(6).uniform(-beta, beta, x.shape).astype(
        np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.asarray(noise))
    want = jreg.UOut(beta=beta).apply({}, jnp.asarray(x), train=True,
                                      rngs={"dropout": jax.random.PRNGKey(0)})
    tm = treg.UOut(beta)
    monkeypatch.setattr(tm, "draw", lambda t: torch.from_numpy(noise))
    _close(tm.train()(torch.from_numpy(x)), want, 1e-6)
    _close(tm.eval()(torch.from_numpy(x)), x, 0)
    tm = treg.UOut(beta)
    tm.generator = torch.Generator().manual_seed(0)
    u = tm.draw(torch.zeros(200_000))
    assert float(u.abs().max()) < beta
    assert abs(float(u.mean())) < 3e-3
    assert abs(float(u.var()) - beta ** 2 / 3) < 1e-3
    # the ADN's uout draws from the generator seed_dropout hands it
    from adell_mri_torch.models.layers.dropout import seed_dropout

    adn = tadn.get_adn_fn("instance", "swish", 0.2, "uout")(3)
    assert seed_dropout(adn, torch.Generator().manual_seed(0)) == 1


@pytest.mark.parametrize("method", ["linear", "trilinear", "cubic",
                                    "tricubic", "lanczos3", "lanczos5",
                                    "nearest"])
@pytest.mark.parametrize("target", [(10, 6, 3), (3, 12, 9)])
def test_resize_like_matches_jax(method, target):
    x = np.random.default_rng(7).normal(size=(2, 5, 8, 6, 3)).astype(
        np.float32)
    want = jmr.resize_like(jnp.asarray(x), target, method=method)
    _close(resize_like(torch.from_numpy(x), target, method), want, 1e-5)


def test_resize_like_refuses_unknown_methods():
    with pytest.raises(NotImplementedError):
        resize_like(torch.zeros(1, 4, 4, 4, 1), (8, 8, 8), "area")


@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("out_ch", [6, 10])
def test_convnext_block_matches_jax(v2, out_ch):
    x = np.random.default_rng(8).normal(size=(2, 9, 8, 5, 6)).astype(
        np.float32)
    jm = JaxConvNeXtBlock(out_channels=out_ch, v2=v2)
    variables = random_variables(jm, jnp.asarray(x), seed=9)
    want = jm.apply(variables, jnp.asarray(x))
    tm = ConvNeXtBlock(6, out_ch, v2=v2)
    state = from_flax(variables["params"])
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)
    _close(tm(torch.from_numpy(x)), want, 1e-5)


@pytest.mark.parametrize("norm", ["batch", "instance", "instance_affine",
                                  "layer", "group", "identity"])
@pytest.mark.parametrize("act", ["prelu", "swish"])
def test_adn_norms_match_jax(norm, act):
    """One ActDropNorm of each norm at C = 12 on a 3D map, eval mode, with
    random parameters and statistics (``make_norm``'s names)."""
    x = (np.random.default_rng(10).normal(size=(2, 5, 4, 3, 12)) * 2
         + 0.5).astype(np.float32)
    jm = jadn.get_adn_fn(3, norm, act)()
    variables = random_variables(jm, jnp.asarray(x), seed=11)
    want = jm.apply(variables, jnp.asarray(x))
    tm = tadn.get_adn_fn(norm, act)(12)
    state = from_flax(variables["params"], variables.get("batch_stats"))
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)
    _close(tm.eval()(torch.from_numpy(x)), want, 1e-5)
