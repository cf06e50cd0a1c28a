"""
The port's U-Net encoder classifier against the JAX package's, on the
CPU: the exact parameter tree (the encoder alone: flax creates the
decoder's parameters only when the decoder runs, and the JAX classifier
returns at the bottleneck), for ``sample_configs/u-net-3d-resnet.yaml``
as it stands and for the CLI's U-Net defaults; the forward (eval by the
head's running statistics, and a training forward's statistics); one
``make_classification_step`` step. Then ``HybridClassifier`` over each
of the four net types this file and its neighbours cover (``ord``,
``unet``, ``vit``, ``factorized_vit``): the JAX modules take no
``return_features``, so a JAX ``HybridClassifier`` over them stops at
its first call; the port's wraps their pooled features.

Tiny shapes (16x16x8 volumes, depths 8-32), seeded numpy inputs and
parameters moved into the port through ``from_flax``; tolerances as in
``tests/test_torch_vit_classifier.py`` (f32 forwards 1e-5 of the output's
scale; the step's loss 1e-5, gradients 2e-4, statistics 1e-5).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.config import factories as jfactories
from adell_mri_torch.config import factories as tfactories
from adell_mri_torch.config.parsing import parse_config_cat
from adell_mri_torch.interop.from_flax import from_flax
from adell_mri_torch.models.layers import adn as tadn
from test_torch_vit_classifier import _close, _x, build, step_matches_jax

CONFIGS = Path(__file__).resolve().parents[1] / "sample_configs"
UNET = dict(depth=[8, 16, 32], conv_type="resnet", link_type="residual",
            upscale_type="transpose", norm_type="instance",
            activation_fn="swish", dropout_param=0.0)
DECODER = ("link_", "up_", "dec_", "Conv_0", "Conv_1", "final_adn",
           "bottleneck_classifier", "ds_")


@pytest.mark.parametrize("which", ["u-net-3d-resnet.yaml", "cli_defaults"])
def test_tree_matches_jax(which):
    """The port's parameters and statistics have the JAX tree's names and
    shapes: ``unet/enc_{i}``, ``unet/enc_ds_{i}`` and ``MLP_0`` (three
    hidden layers of ``depth[-1]``, each with a batch-norm gelu ADN), no
    decoder or segmentation head key."""
    cfg = (parse_config_cat(str(CONFIGS / which))["network"]
           if which.endswith(".yaml") else {})
    shape = (32, 32, 16)
    jm = jfactories.get_classification_network("unet", cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + shape + (1,)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = from_flax(zeros["params"], zeros.get("batch_stats"))
    tm = tfactories.get_classification_network("unet", cfg)
    got = tm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == tuple(v.shape), k
    unet = {k.split(".")[1] for k in got if k.startswith("unet.")}
    assert unet and not any(n.startswith(DECODER) for n in unet), unet
    depth = cfg.get("depth", (16, 32, 64))
    assert {n for n in unet if n.startswith("enc_ds_")} == {
        f"enc_ds_{i}" for i in range(len(depth) - 1)}
    assert tuple(got["MLP_0.Dense_2.weight"].shape) == (depth[-1],) * 2
    assert "MLP_0.ActDropNorm_2.GlobalBatchNorm_0.mean" in got


@pytest.mark.parametrize("n_classes", [2, 3])
@pytest.mark.parametrize("norm_fn", ["batch", "layer"])
def test_forward_matches_jax(n_classes, norm_fn):
    """Eval logits by the head's running statistics (``norm_fn`` sets the
    head's norm; the encoder's is ``norm_type``'s instance norm), and a
    training forward's head statistics."""
    x = _x(b=3, seed=50)
    cfg = dict(UNET, norm_fn=norm_fn)
    jm, params, bs, tm = build("unet", cfg, n_classes, x, seed=51,
                               batch_stats=True)
    variables = {"params": params, **({"batch_stats": bs} if bs else {})}
    want = jm.apply(variables, jnp.asarray(x))
    assert want.shape == (3, 1 if n_classes == 2 else n_classes)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), want)
    if not bs:
        return
    _, upd = jm.apply(variables, jnp.asarray(x), train=True,
                      mutable=["batch_stats"])
    tm.train()
    with torch.no_grad():
        tm(torch.from_numpy(x))
    got = tadn.pop_batch_stats(tm)
    want = from_flax({}, upd["batch_stats"])
    assert set(got) == set(want)
    for k, w in want.items():
        assert float((got[k] - w).abs().max()) <= 1e-5 * max(
            float(w.abs().max()), 1e-3), k


def test_classification_step_matches_jax():
    x = _x(b=4, seed=60)
    jm, params, bs, tm = build("unet", UNET, 2, x, seed=61,
                               batch_stats=True)
    y = np.asarray([0, 1, 1, 0], np.float32)
    step_matches_jax(jm, params, bs, tm, {"image": x, "label": y}, 2)


HYBRID = {
    "ord": dict(resnet_structure=[[8, 16, 3, 1], [16, 32, 3, 1]]),
    "unet": UNET,
    "vit": dict(patch_size=[4, 4, 2], embed_dim=32, n_blocks=1, n_heads=2),
    "factorized_vit": dict(patch_size=[4, 4], embed_dim=32, n_blocks=2,
                           n_heads=2),
}


@pytest.mark.parametrize("net_type", list(HYBRID))
def test_hybrid_wraps_new_net_types(net_type):
    """The JAX factory's ``HybridClassifier`` over the net type stops at
    its first call (``return_features``); the port's wraps the headless
    network: ``convolutional_module`` without head parameters, its pooled
    features beside the standardised tabular ones, then Dense, relu,
    Dense; equal to the parts applied by hand."""
    cfg = HYBRID[net_type]
    feats = dict(clinical_feature_means=[50.0, 0.5],
                 clinical_feature_stds=[10.0, 0.25])
    x = _x(b=3, seed=70)
    tab = np.asarray([[61.0, 0.2], [48.0, 0.9], [55.0, 0.4]], np.float32)
    jm = jfactories.get_classification_network(net_type, cfg, **feats)
    with pytest.raises(TypeError, match="return_features"):
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(tab))
    torch.manual_seed(0)
    tm = tfactories.get_classification_network(
        net_type, cfg, image_size=x.shape[1:-1], **feats).eval()
    names = set(tm.state_dict())
    assert {"Dense_0.weight", "Dense_1.weight"} <= names
    assert not any(k.startswith(("convolutional_module.MLP_0",
                                 "convolutional_module.threshold",
                                 "convolutional_module.Dense"))
                   for k in names)
    xt, tt = torch.from_numpy(x), torch.from_numpy(tab)
    with torch.no_grad():
        got = tm(xt, tt)
        inner = tm.convolutional_module(xt, return_features=True)
        std = (tt - torch.tensor([50.0, 0.5])) / torch.tensor([10.0, 0.25])
        h = torch.relu(tm.Dense_0(torch.cat([inner, std], -1)))
        _close(got, tm.Dense_1(h).numpy())
    assert got.shape == (3, 1)
