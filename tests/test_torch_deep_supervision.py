"""
Bottleneck classification and deep supervision in the port against the JAX
package, on the CPU, for the U-Net, UNETR and SWIN-UNet.

Each net is built on both sides with both heads on, at narrow widths;
parameters drawn from a seeded numpy generator move into the port through
``from_flax``, and the same numpy batch goes through both in f32 (dropout
0). Tolerances, two frameworks summing the same products in other orders:
the prediction, the bottleneck logits and every deep-supervision output
within 1e-5 absolute (they are probabilities and O(1) logits); the
training step's loss (segmentation + weighted deep-supervision + class
loss) within 1e-4 relative, each metric within 1e-4, and every
parameter's gradient within 1e-4 of its own scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.config import factories as jfactories
from adell_mri_tpu.config import parsing as jparsing
from adell_mri_tpu.models.segmentation.unet import UNet as JaxUNet
from adell_mri_tpu.train import steps as jsteps
from adell_mri_torch.config import factories as tfactories
from adell_mri_torch.config import parsing as tparsing
from adell_mri_torch.inference import sliding_window_inference
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.segmentation.heads import prediction_of
from adell_mri_torch.models.segmentation.unet import UNet
from adell_mri_torch.train import steps as tsteps
from test_torch_unet import FLAGSHIP_SMALL, random_flax_params

HEADS = dict(bottleneck_classification=True, deep_supervision=True)
UNETR_CONFIG = dict(
    patch_size=[8, 8, 4], embedding_size=16, number_of_blocks=4, n_heads=2,
    feature_size=4, n_channels=1, dropout_rate=0.0,
)
SWIN_CONFIG = dict(
    patch_size=[2, 2, 2], window_size=[4, 4, 4], embedding_size=[8, 16, 32],
    n_heads=2, n_channels=1, dropout_rate=0.0,
)
# net type -> input size, with the number of decoder outputs
NETS = {
    "unet": ((16, 16, 8), 2),
    "unetr": ((16, 16, 8), 4),
    "swin": ((12, 16, 10), 3),
}
LOSS = {"dice": {"eps": 1.0e-6}, "focal": {"gamma": 0.0}}


def _models(net, heads=HEADS):
    if net == "unet":
        return JaxUNet(**FLAGSHIP_SMALL, **heads), UNet(
            **FLAGSHIP_SMALL, **heads)
    cfg = {**(UNETR_CONFIG if net == "unetr" else SWIN_CONFIG), **heads}
    size = NETS[net][0]
    return (jfactories.get_segmentation_network(net, cfg, n_classes=2),
            tfactories.get_segmentation_network(net, cfg, n_classes=2,
                                                image_size=size))


def _batch(net, seed=0):
    rng = np.random.default_rng(seed)
    size = NETS[net][0]
    image = rng.uniform(size=(2,) + size + (1,)).astype(np.float32)
    label = (rng.uniform(size=(2,) + size) > 0.6).astype(np.float32)
    # one volume without foreground: its class target is 0
    label[1] = 0.0
    return image, label


@pytest.fixture(scope="module", params=list(NETS))
def pair(request):
    net = request.param
    image, label = _batch(net)
    jm, tm = _models(net)
    params = random_flax_params(jm, jnp.asarray(image), seed=5)
    state = from_flax(params)
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)
    return dict(net=net, jm=jm, tm=tm.eval(), params=params, image=image,
                label=label)


def test_heads_match_jax(pair):
    jm, tm, image = pair["jm"], pair["tm"], pair["image"]
    want = jax.jit(jm.apply)({"params": pair["params"]}, jnp.asarray(image))
    with torch.no_grad():
        got = tm(torch.from_numpy(image))
    assert isinstance(got, tuple) and len(got) == 3
    pred, bn_out, ds = got
    assert pred.shape == image.shape
    assert bn_out.shape == (2, 1)
    assert len(ds) == len(want[2]) == NETS[pair["net"]][1]
    for g, w in [(pred, want[0]), (bn_out, want[1])] + list(zip(ds, want[2])):
        assert tuple(g.shape) == tuple(w.shape)
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) < 1e-5


@pytest.mark.parametrize("heads", [
    dict(bottleneck_classification=True),
    dict(deep_supervision=True),
], ids=["bottleneck", "deep_supervision"])
def test_one_head_returns_what_jax_returns(heads):
    net = "swin"
    image, _ = _batch(net)
    jm, tm = _models(net, heads)
    params = random_flax_params(jm, jnp.asarray(image), seed=6)
    tm.load_state_dict(from_flax(params))
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(image))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(image))
    assert len(got) == len(want)
    assert (got[1] is None) == (want[1] is None)
    assert float(np.abs(got[0].numpy() - np.asarray(want[0])).max()) < 1e-5


@pytest.fixture(scope="module")
def step(pair):
    """One training step with both heads' losses on both sides."""
    jm, tm, image, label = pair["jm"], pair["tm"], pair["image"], pair[
        "label"]
    jlm = jsteps.make_segmentation_step(
        jm, jparsing.build_compound_loss(LOSS, 2), train=True, **HEADS
    )
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jlm, has_aux=True))(
        pair["params"],
        {"image": jnp.asarray(image), "label": jnp.asarray(label)},
        jax.random.PRNGKey(0),
    )
    tlm = tsteps.make_segmentation_step(
        tm, tparsing.build_compound_loss(LOSS, 2), train=True, **HEADS
    )
    tparams = dict(tm.named_parameters())
    tloss, tmet = tlm(
        tparams,
        {"image": torch.from_numpy(image), "label": torch.from_numpy(label)},
    )
    names = list(tparams)
    tgrads = torch.autograd.grad(tloss, [tparams[k] for k in names])
    tm.eval()
    return dict(jloss=float(jloss), tloss=float(tloss),
                jmet={k: float(v) for k, v in jmet.items()},
                tmet={k: float(v) for k, v in tmet.items()},
                jgrads=from_flax(jgrads), tgrads=dict(zip(names, tgrads)))


def test_step_loss_and_metrics_match_jax(step):
    assert abs(step["tloss"] - step["jloss"]) <= 1e-4 * abs(step["jloss"])
    assert "loss_class_loss" in step["jmet"]
    assert set(step["tmet"]) == set(step["jmet"])
    for k, v in step["jmet"].items():
        assert abs(step["tmet"][k] - v) <= 1e-4 * max(abs(v), 1e-3), k


def test_step_gradients_match_jax(step):
    jg, tg = step["jgrads"], step["tgrads"]
    assert set(jg) == set(tg)
    assert any(k.startswith("ds_out_") for k in jg)
    assert "bottleneck_classifier.weight" in jg
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


def test_label_resize_is_jax_nearest():
    y = np.random.default_rng(2).integers(0, 3, size=(2, 9, 7, 5)).astype(
        np.float32)
    for shape in [(4, 3, 2), (9, 7, 5), (5, 4, 3)]:
        want = np.asarray(jsteps._resize_to(jnp.asarray(y), shape))
        got = tsteps._resize_to(torch.from_numpy(y), shape).numpy()
        np.testing.assert_array_equal(got, want)
        want = np.asarray(jsteps._resize_to(jnp.asarray(y[..., None]),
                                             shape))
        got = tsteps._resize_to(torch.from_numpy(y[..., None]), shape)
        np.testing.assert_array_equal(got.numpy(), want)


def test_step_refuses_heads_the_model_lacks():
    """The step takes the model's heads; the JAX signature's flags, where
    given, must match them."""
    model = UNet(**FLAGSHIP_SMALL, deep_supervision=True)
    loss = tparsing.build_compound_loss({"dice": {}}, 2)
    tsteps.make_segmentation_step(model, loss, deep_supervision=True)
    tsteps.make_segmentation_step(model, loss)
    with pytest.raises(ValueError, match="bottleneck classification"):
        tsteps.make_segmentation_step(model, loss,
                                      bottleneck_classification=True)
    with pytest.raises(ValueError, match="turned off"):
        tsteps.make_segmentation_step(model, loss, deep_supervision=False)


def test_step_without_flags_takes_the_models_heads(pair, step):
    """The step built without the flags computes the loss that the step
    built with them does."""
    tm = pair["tm"]
    tlm = tsteps.make_segmentation_step(
        tm, tparsing.build_compound_loss(LOSS, 2), train=True
    )
    with torch.no_grad():
        loss, metrics = tlm(dict(tm.named_parameters()), {
            "image": torch.from_numpy(pair["image"]),
            "label": torch.from_numpy(pair["label"])})
    tm.eval()
    assert "loss_class_loss" in metrics
    assert float(loss) == step["tloss"]


def test_sliding_window_takes_the_prediction():
    """A model with heads serves through the sliding window with
    ``heads=False`` as its full forward's prediction does."""
    _, tm = _models("swin")
    vol = torch.from_numpy(_batch("swin")[0][0])
    with torch.no_grad():
        got = sliding_window_inference(
            lambda x: tm.eval()(x, heads=False), vol, (12, 16, 8))
        want = sliding_window_inference(
            lambda x: prediction_of(tm(x)), vol, (12, 16, 8))
    assert got.shape == vol.shape
    assert torch.equal(got, want)


def test_inference_runs_no_head(pair):
    """``heads=False`` returns the prediction alone and runs none of the
    heads' modules (the JAX predict's jit drops them)."""
    tm, image = pair["tm"], torch.from_numpy(pair["image"])
    ran = []
    hooks = [m.register_forward_hook(lambda *_, n=n: ran.append(n))
             for n, m in tm.named_children()
             if n.startswith("ds_") or n == "bottleneck_classifier"]
    assert len(hooks) == 3 * NETS[pair["net"]][1] + 1
    try:
        with torch.no_grad():
            got = tm(image, heads=False)
    finally:
        for h in hooks:
            h.remove()
    assert ran == []
    with torch.no_grad():
        want = tm(image)[0]
    assert torch.is_tensor(got)
    assert torch.equal(got, want)
