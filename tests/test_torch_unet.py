"""
The port's flagship-configuration UNet against the JAX UNet, on the CPU.

A JAX ``UNet`` with the flagship flags (regular convs, residual links,
transposed upsampling, instance norm, swish) at depth (4, 8, 16) takes a
16x16x8 input in f32; its parameters, drawn from a seeded numpy generator,
move into the port through ``from_flax``. Tolerance: 1e-4 relative to the
logits' scale (f32 on both sides; the sums run in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.models.segmentation.unet import UNet as JaxUNet
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.segmentation.unet import UNet

FLAGSHIP_SMALL = dict(
    spatial_dimensions=3,
    conv_type="regular",
    link_type="residual",
    upscale_type="transpose",
    norm_type="instance",
    activation_fn="swish",
    dropout_param=0.0,
    n_classes=2,
    depth=(4, 8, 16),
    kernel_sizes=(3, 3, 3),
    strides=(2, 2, 2),
)


def random_flax_params(module, x, seed=0):
    """Parameters of ``module`` drawn from numpy (biases too, so that the
    bias paths are exercised); shapes come from ``eval_shape``."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)["params"]
    rng = np.random.default_rng(seed)

    def draw(s):
        scale = 0.3 if len(s.shape) == 1 else 1.0 / np.sqrt(
            np.prod(s.shape[:-1])
        )
        return (rng.normal(size=s.shape) * scale).astype(np.float32)

    return jax.tree.map(draw, shapes)


@pytest.fixture(scope="module")
def pair():
    x = np.random.default_rng(1).normal(size=(2, 16, 16, 8, 1))
    x = x.astype(np.float32)
    jm = JaxUNet(**FLAGSHIP_SMALL)
    params = random_flax_params(jm, jnp.asarray(x))
    logits = jax.jit(
        lambda p, v: jm.apply({"params": p}, v, return_logits=True)[0]
    )(params, jnp.asarray(x))
    tm = UNet(**FLAGSHIP_SMALL)
    state = from_flax(params)
    tm.load_state_dict(state)
    return dict(
        x=x, logits=np.asarray(logits), model=tm.eval(), state=state
    )


def test_unet_logits_match_jax(pair):
    with torch.no_grad():
        got = pair["model"](
            torch.from_numpy(pair["x"]), return_logits=True
        ).numpy()
    want = pair["logits"]
    assert got.shape == want.shape == (2, 16, 16, 8, 1)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
    with torch.no_grad():
        prob = pair["model"](torch.from_numpy(pair["x"])).numpy()
    np.testing.assert_allclose(prob, 1 / (1 + np.exp(-want)), atol=1e-5)


def test_from_flax_maps_every_key(pair):
    assert set(pair["state"]) == set(pair["model"].state_dict())
    for k, v in pair["model"].state_dict().items():
        assert tuple(pair["state"][k].shape) == tuple(v.shape), k


def test_unet_bf16_forward_runs(pair):
    model = UNet(**FLAGSHIP_SMALL)
    model.load_state_dict(pair["state"])
    model = model.to(torch.bfloat16).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(pair["x"]).bfloat16())
    assert out.dtype == torch.bfloat16
    assert out.shape == (2, 16, 16, 8, 1)
    out = out.float()
    assert torch.isfinite(out).all()
    want = torch.from_numpy(pair["logits"]).sigmoid()
    assert float((out - want).abs().max()) < 0.1


@pytest.mark.parametrize(
    "option",
    [
        {"skip_conditioning": 1},
        {"semi_supervised": True},
        {"conv_type": "sae_ref"},
        {"feature_conditioning": 2},
        {"spatial_dimensions": 2},
        {"conv_type": "depthwise_ref"},
    ],
)
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError):
        UNet(**{**FLAGSHIP_SMALL, **option})
