"""
The U-Net with a ResNet encoder (``encoder_structure``: an SSL backbone
grafted under ``encoder_backbone``) against the JAX UNet, on the CPU.

A JAX ``UNet(encoder_structure=...)`` at a tiny width (two stages of 4
and 8 channels, batch norm, swish, transposed upsampling) with the
anisotropic strides ``segmentation train --res_config_file`` derives
(``[2, *maxpool_structure]``) takes a 16x16x8 input in f32; its
parameters and running statistics, drawn from a seeded numpy generator,
move into the port through ``from_flax``. Held: the eval logits within
1e-4 of their scale; the backbone's skips (``return_intermediate``,
``return_stem``) within 1e-5; one training step's loss within 1e-5
relative, each leaf's gradient within 1e-4 of the largest gradient's
scale, and the updated running statistics within 1e-5. A ``depth`` that
is not ``[stem_f, *stage_channels]`` raises as in the JAX module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.config import parsing as jparsing
from adell_mri_tpu.models.layers.res_net import (
    ResNetBackbone as JaxBackbone,
)
from adell_mri_tpu.models.layers.adn import get_adn_fn as jget_adn_fn
from adell_mri_tpu.models.segmentation.unet import UNet as JaxUNet
from adell_mri_tpu.train import steps as jsteps
from adell_mri_torch.config import parsing as tparsing
from adell_mri_torch.interop.from_flax import flax_path, from_flax
from adell_mri_torch.models.layers.adn import get_adn_fn
from adell_mri_torch.models.layers.res_net import ResNetBackbone
from adell_mri_torch.models.segmentation.unet import UNet
from adell_mri_torch.train import steps as tsteps
from adell_mri_torch.train.optim import get_optimizer
from adell_mri_torch.train.state import TrainState
from test_torch_unet_options import random_variables

STRUCTURE = [[4, 4, 3, 1], [8, 8, 3, 1]]
MAXPOOLS = [[2, 2, 1], [2, 2, 2]]
ENCODER_UNET = dict(
    spatial_dimensions=3, conv_type="regular", link_type="identity",
    upscale_type="transpose", norm_type="batch", activation_fn="swish",
    dropout_param=0.0, n_classes=2, depth=(4, 4, 8),
    kernel_sizes=(3, 3, 3),
    strides=(2, (2, 2, 1), (2, 2, 2)),
    encoder_structure=tuple(tuple(s) for s in STRUCTURE),
)
SHAPE = (2, 16, 16, 8, 1)
LOSS = {"dice": {}, "focal": {"gamma": 1.0}}


def _x(seed=1):
    return np.random.default_rng(seed).normal(size=SHAPE).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    x = _x()
    jm = JaxUNet(**ENCODER_UNET)
    variables = random_variables(jm, jnp.asarray(x), seed=3)
    tm = UNet(**ENCODER_UNET)
    state = from_flax(variables["params"], variables["batch_stats"])
    tm.load_state_dict(state)
    return dict(x=x, jm=jm, variables=variables, tm=tm, state=state)


def test_encoder_unet_logits_match_jax(pair):
    logits = pair["jm"].apply(pair["variables"], jnp.asarray(pair["x"]),
                              return_logits=True)[0]
    want = np.asarray(logits)
    with torch.no_grad():
        got = pair["tm"].eval()(torch.from_numpy(pair["x"]),
                                return_logits=True).numpy()
    assert got.shape == want.shape == SHAPE
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-4
    # the whole tree moved, the encoder under encoder_backbone
    assert set(pair["state"]) == set(pair["tm"].state_dict())
    assert any(k.startswith("encoder_backbone.ResidualBlock_")
               for k in pair["state"])
    assert not any(k.startswith("enc_") for k in pair["state"])


def test_backbone_skips_match_jax():
    """The skips: the stem's output before its pool, then each stage's
    before its pool; the last pooled map beside them."""
    x = _x(4)
    jb = JaxBackbone(structure=[tuple(s) for s in STRUCTURE],
                     maxpool_structure=[tuple(m) for m in MAXPOOLS],
                     adn_fn=jget_adn_fn(3, "instance", "swish"))
    variables = random_variables(jb, jnp.asarray(x), seed=5)
    jout, jskips = jb.apply(variables, jnp.asarray(x),
                            return_intermediate=True, return_stem=True)
    tb = ResNetBackbone(1, [tuple(s) for s in STRUCTURE],
                        maxpool_structure=MAXPOOLS,
                        adn_fn=get_adn_fn("instance", "swish"))
    tb.load_state_dict(from_flax(variables["params"]))
    with torch.no_grad():
        tout, tskips = tb(torch.from_numpy(x), return_intermediate=True,
                          return_stem=True)
        _, no_stem = tb(torch.from_numpy(x), return_intermediate=True)
    assert [tuple(s.shape) for s in tskips] == [
        (2, 16, 16, 8, 4), (2, 8, 8, 4, 4), (2, 4, 4, 4, 8)]
    assert len(no_stem) == 2
    for got, want in zip([tout] + list(tskips), [jout] + list(jskips)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5 * float(np.abs(want).max()))


def test_encoder_unet_step_matches_jax(pair):
    """One training step (f32, batch statistics): loss, every leaf's
    gradient and the running statistics the step returns."""
    image = _x(6)
    label = np.zeros(SHAPE[:-1], np.float32)
    label[:, 4:10, 5:12, 2:6] = 1.0
    jlm = jsteps.make_segmentation_step(
        pair["jm"], jparsing.build_compound_loss(LOSS, 2), train=True)
    batch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
    variables = pair["variables"]

    def jloss_fn(p):
        return jlm(p, batch, jax.random.PRNGKey(0),
                   {"batch_stats": variables["batch_stats"]})

    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jloss_fn, has_aux=True))(variables["params"])
    tm = UNet(**ENCODER_UNET)
    tm.load_state_dict(pair["state"])
    tlm = tsteps.make_segmentation_step(
        tm, tparsing.build_compound_loss(LOSS, 2), train=True)
    state = TrainState.create(
        tm, lambda p: get_optimizer("sgd", 1e-3, params=p))
    tloss, tmet = tlm(state.weights(), {"image": torch.from_numpy(image),
                                        "label": torch.from_numpy(label)})
    names = list(state.params)
    grads = torch.autograd.grad(tloss, [state.params[k] for k in names])
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = from_flax(jgrads)
    scale = max(float(v.abs().max()) for v in want.values())
    assert len(want) == len(names)
    for name, g in zip(names, grads):
        path = flax_path(name, g)
        key = next(k for k in want if flax_path(k, want[k]) == path)
        err = float((g - want[key]).abs().max())
        assert err <= 1e-4 * scale, (name, err, scale)
    want_bs = from_flax({}, jmet["_variables"]["batch_stats"])
    got_bs = tmet["_variables"]
    assert set(got_bs) == set(want_bs)
    for k, v in want_bs.items():
        err = float((got_bs[k] - v).abs().max())
        assert err <= 1e-5 * max(1.0, float(v.abs().max())), (k, err)


def test_encoder_depth_must_match_the_backbone():
    bad = dict(ENCODER_UNET, depth=(4, 8, 8))
    with pytest.raises(ValueError, match="stem_f"):
        UNet(**bad)
    with pytest.raises(ValueError, match="stem_f"):
        JaxUNet(**bad).init(jax.random.PRNGKey(0), jnp.zeros(SHAPE))
