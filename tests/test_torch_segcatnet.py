"""
The modules that SegCatNet is built from, and SegCatNet, against the JAX
package's on the CPU: ``ProjectionHead`` and ``ResNet`` (every return
level, train and eval), the U-Net's ``return_features`` forward,
``SegCatNet``'s forward and a step, and ``SliceLinearEmbedding``.

Tiny shapes, seeded numpy inputs, parameters and running statistics
moved into the port through ``from_flax``. Tolerances: f32 forwards and
running statistics 1e-5 of the output's scale; the step's loss 1e-5 and
each gradient 1e-4 of its own scale. The ADNs of the ``ResNet`` cases
drop nothing (dropout 0), so a training forward is deterministic in both
packages; SegCatNet's fixed dropout of 0.1 keeps its step in eval mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adell_mri_tpu.models.classification.nets import SegCatNet as JaxSegCatNet
from adell_mri_tpu.models.layers.adn import get_adn_fn as jget_adn_fn
from adell_mri_tpu.models.layers.res_net import (
    ProjectionHead as JaxProjectionHead,
)
from adell_mri_tpu.models.layers.res_net import ResNet as JaxResNet
from adell_mri_tpu.models.layers.vit import (
    SliceLinearEmbedding as JaxSliceLinearEmbedding,
)
from adell_mri_tpu.models.segmentation.unet import UNet as JaxUNet
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.classification.nets import SegCatNet
from adell_mri_torch.models.layers.adn import get_adn_fn, pop_batch_stats
from adell_mri_torch.models.layers.res_net import ProjectionHead, ResNet
from adell_mri_torch.models.layers.vit import SliceLinearEmbedding
from adell_mri_torch.models.segmentation.unet import UNet
from test_torch_classification import _close

SHAPE = (16, 16, 8)
UNET = dict(depth=[4, 8], kernel_sizes=[3, 3], strides=[2, 2],
            conv_type="regular", norm_type="batch", activation_fn="swish",
            dropout_param=0.0)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _draw(tree, seed):
    rng = np.random.default_rng(seed)

    def one(s):
        scale = 0.3 if len(s.shape) == 1 else 1.0 / np.sqrt(
            np.prod(s.shape[:-1]))
        return jnp.asarray((rng.normal(size=s.shape) * scale).astype(
            np.float32))

    return jax.tree.map(one, tree)


def _variables(jm, x, seed=0, **kw):
    """Parameters and running statistics drawn from a seed."""
    shapes = jax.eval_shape(lambda v: jm.init(jax.random.PRNGKey(0), v,
                                              **kw), x)
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree.map(lambda s: jnp.asarray(rng.uniform(
        0.5, 1.5, s.shape).astype(np.float32)), shapes.get("batch_stats", {}))
    return {"params": _draw(shapes["params"], seed), "batch_stats": stats}


def _stats_match(tm, new):
    """The running statistics a training forward computed, against the
    JAX module's updated collection."""
    got = pop_batch_stats(tm)
    want = from_flax({}, new["batch_stats"])
    assert set(got) == set(want)
    for path, value in want.items():
        _close(got[path], value, 1e-5)


def _load(tm, variables):
    tm.load_state_dict(from_flax(variables["params"],
                                 variables["batch_stats"]))
    return tm


@pytest.mark.parametrize("train", [False, True])
def test_projection_head(train):
    x = _x((5, 6, 6, 4, 8), seed=1)
    jm = JaxProjectionHead((16, 12, 4), adn_fn=jget_adn_fn(1, "batch",
                                                           "swish", 0.0))
    v = _variables(jm, x)
    tm = _load(ProjectionHead(8, (16, 12, 4),
                              get_adn_fn("batch", "swish", 0.0,
                                         spatial_dim=1)), v)
    want, new = jm.apply(v, x, train=train, mutable=["batch_stats"])
    got = tm.train(train)(torch.from_numpy(x))
    _close(got, want, 1e-5)
    if train:
        _stats_match(tm, new)


RESNET = dict(backbone_structure=((8, 16, 3, 1), (16, 16, 3, 1)),
              maxpool_structure=(2, 2), res_type="resnet",
              projection_head_structure=(16, 8),
              prediction_head_structure=(8, 4))


@pytest.mark.parametrize("ret", ["representation", "projection",
                                 "prediction"])
@pytest.mark.parametrize("train", [False, True])
def test_resnet(ret, train):
    x = _x((3,) + SHAPE + (2,), seed=2)
    jm = JaxResNet(adn_fn=jget_adn_fn(3, "batch", "swish", 0.0),
                   head_adn_fn=jget_adn_fn(1, "batch", "swish", 0.0),
                   **RESNET)
    v = _variables(jm, x, seed=3)
    tm = _load(ResNet(2, adn_fn=get_adn_fn("batch", "swish", 0.0),
                      head_adn_fn=get_adn_fn("batch", "swish", 0.0,
                                             spatial_dim=1), **RESNET), v)
    want, new = jm.apply(v, x, train=train, ret=ret,
                         mutable=["batch_stats"])
    got = tm.train(train)(torch.from_numpy(x), ret=ret)
    _close(got, want, 1e-5)
    if train:
        _stats_match(tm, new)


def test_unet_return_features():
    x = _x((2,) + SHAPE + (1,), seed=4)
    jm = JaxUNet(**UNET)
    v = _variables(jm, x, seed=5, return_features=True)
    tm = _load(UNet(**UNET), v).eval()
    want = jm.apply(v, x, train=False, return_features=True)
    got = tm(torch.from_numpy(x), return_features=True)
    assert len(got) == 3
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


@pytest.fixture(scope="module")
def segcatnet():
    x = _x((2, 32, 32, 16, 1), seed=6)
    jm = JaxSegCatNet(unet=JaxUNet(**UNET))
    v = _variables(jm, x, seed=7)
    tm = _load(SegCatNet(UNet(**UNET)), v).eval()
    return jm, v, tm, x


def test_segcatnet_forward(segcatnet):
    jm, v, tm, x = segcatnet
    want = jm.apply(v, x, train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 1)
    _close(got, want, 1e-5)


def test_segcatnet_step_leaves_the_unet(segcatnet):
    """The loss and gradients of a step (eval mode: the ADNs' dropout of
    0.1 would draw differently): the heads' gradients agree, and no
    gradient reaches the U-Net in either package."""
    jm, v, tm, x = segcatnet
    y = np.asarray([0.0, 1.0], np.float32)

    def jloss(params):
        logits = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, x)[:, 0]
        return jnp.mean(jnp.logaddexp(0.0, logits) - y * logits)

    want_loss, want_grads = jax.value_and_grad(jloss)(v["params"])
    tm.zero_grad()
    logits = tm(torch.from_numpy(x))[:, 0]
    loss = F.binary_cross_entropy_with_logits(logits, torch.from_numpy(y))
    loss.backward()
    _close(loss, want_loss, 1e-5)
    unet_grads = jax.tree.leaves(want_grads["unet"])
    assert unet_grads and all(float(jnp.abs(g).max()) == 0.0
                              for g in unet_grads)
    want = from_flax(want_grads)
    for name, p in tm.named_parameters():
        if name.startswith("unet."):
            assert p.grad is None, name
        else:
            _close(p.grad, want[name], 1e-4)


@pytest.mark.parametrize("embed_method", ["linear", "convolutional"])
@pytest.mark.parametrize("use_class_token", [False, True])
@pytest.mark.parametrize("learnable_embedding", [True, False])
def test_slice_linear_embedding(embed_method, use_class_token,
                                learnable_embedding):
    x = _x((2, 16, 12, 5, 2), seed=8)
    kw = dict(embed_method=embed_method, use_class_token=use_class_token,
              learnable_embedding=learnable_embedding)
    jm = JaxSliceLinearEmbedding(patch_size=(4, 4), embed_dim=24, **kw)
    v = _variables(jm, x, seed=9)
    tm = _load(SliceLinearEmbedding(2, (16, 12), (4, 4), embed_dim=24,
                                    **kw), v)
    want = jm.apply(v, x)
    got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 5, 12 + use_class_token, 24)
    _close(got, want, 1e-5)
