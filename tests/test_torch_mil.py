"""
The 2D classifiers and the MIL models, the port's against the JAX
package's, on the CPU.

- CatNet, VGG and OrdNet on 2D inputs ``[B, 32, 32, 1]`` (``ndim=2``; the
  JAX modules take the rank of their input) at tiny widths, and with
  ``spatial_dimensions: 2`` through both factories on 3D inputs, where
  the JAX modules are 3D networks (the classification CLI's volumes) and
  so are the port's: eval logits within 1e-4 of their scale; one f32
  training step's loss within 1e-5 relative and every leaf's gradient
  within 1e-4 of the largest gradient's scale. A CatNet whose
  ``maxpool_structure`` has two entries a stage on a 3D input fails in
  both packages (``ValueError``), the port where it is built.
- ``MILAttention``, ``MultipleInstanceClassifier`` and
  ``TransformableTransformer`` over the JAX CLI's slice encoder (a
  headless 2D VGG with instance norm) on ``[2, 16, 16, 4, 1]`` volumes:
  the same tolerances for the logits, the attention weights, one
  training step's loss and gradients.

Weights are drawn from a seeded numpy generator and move through
``from_flax``; inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.config.factories import (
    get_classification_network as jget_network,
)
from adell_mri_tpu.entrypoints.classification_mil.train import (
    build_mil_model as jbuild_mil_model,
)
from adell_mri_tpu.models.classification.losses import (
    binary_logistic_loss as jbinary_loss,
    ordinal_sigmoidal_loss as jordinal_loss,
)
from adell_mri_tpu.models.classification.mil import (
    MILAttention as JaxMILAttention,
)
from adell_mri_tpu.train import steps as jsteps
from adell_mri_torch.config.factories import get_classification_network
from adell_mri_torch.entrypoints.classification_mil.train import (
    build_mil_model,
)
from adell_mri_torch.interop.from_flax import flax_path, from_flax
from adell_mri_torch.models.classification import losses as tlosses
from adell_mri_torch.models.classification.mil import MILAttention
from adell_mri_torch.models.classification.nets import VGG, CatNet, OrdNet
from adell_mri_torch.train import steps as tsteps
from test_torch_unet_options import random_variables

STRUCTURE = [[4, 8, 3, 1], [8, 16, 3, 1]]
NETS_2D = {
    "cat": (CatNet, dict(resnet_structure=STRUCTURE,
                         maxpool_structure=[[2, 2], [2, 2]])),
    "vgg": (VGG, dict(first_depth=4, n_blocks=2,
                      classification_structure=(8, 8))),
    "ord": (OrdNet, dict(resnet_structure=STRUCTURE, n_classes=3)),
}
MIL_CFG = {"first_depth": 4, "n_blocks": 2, "attention_dim": 8,
           "embed_dim": 8, "n_heads": 2, "transformer_blocks": 1}
VOLUMES = (2, 16, 16, 4, 1)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, tol):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, (err, scale)


def _check_grads(tgrads, names, jgrads, tol=1e-4):
    want = {flax_path(k, v): v for k, v in from_flax(jgrads).items()}
    scale = max(float(v.abs().max()) for v in want.values())
    assert len(want) == len(names)
    for name, g in zip(names, tgrads):
        err = float((g - want[flax_path(name, g)]).abs().max())
        assert err <= tol * scale, (name, err, scale)


def _step_pair(jm, variables, tm, x, y, jloss_fn, tloss_fn, n_classes):
    """One f32 training step on each side (dropout the identity): the
    losses, then the gradients, held as the module docstring says."""
    jlm = jsteps.make_classification_step(jm, jloss_fn, n_classes, True)
    batch = {"image": jnp.asarray(x), "label": jnp.asarray(y)}
    extra = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(p):
        return jlm(p, batch, jax.random.PRNGKey(0), extra or None)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    tlm = tsteps.make_classification_step(tm, tloss_fn, n_classes=n_classes,
                                          train=True)
    params = dict(tm.named_parameters())
    weights = {**tm.state_dict(), **params}
    tloss, _ = tlm(weights, {"image": torch.from_numpy(x),
                             "label": torch.from_numpy(y)})
    names = list(params)
    grads = torch.autograd.grad(tloss, [params[k] for k in names])
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _check_grads(grads, names, jgrads)


def _no_dropout(monkeypatch):
    import flax.linen as fnn

    from adell_mri_torch.models.layers.dropout import Dropout

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(Dropout, "forward", lambda self, x: x)


@pytest.mark.parametrize("net_type", list(NETS_2D))
def test_2d_classifier_matches_jax(net_type, monkeypatch):
    _no_dropout(monkeypatch)
    cls, kw = NETS_2D[net_type]
    n_classes = kw.get("n_classes", 2)
    jkw = dict(kw, spatial_dimensions=2)
    import adell_mri_tpu.models.classification.nets as jnets

    jm = getattr(jnets, cls.__name__)(**jkw)
    x = _x((2, 32, 32, 1), seed=1)
    variables = random_variables(jm, jnp.asarray(x), seed=2)
    tm = cls(spatial_dimensions=2, ndim=2, **kw)
    tm.load_state_dict(from_flax(variables["params"],
                                 variables.get("batch_stats")))
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    _close(got.numpy(), want, 1e-4)
    if net_type == "ord":
        y = np.asarray([0, 2], np.float32)
        jloss = lambda lg, t: jordinal_loss(lg, t, n_classes)  # noqa: E731
        tloss = lambda lg, t: tlosses.ordinal_sigmoidal_loss(  # noqa: E731
            lg, t, n_classes)
    else:
        y = np.asarray([0.0, 1.0], np.float32)
        jloss, tloss = jbinary_loss, tlosses.binary_logistic_loss
    tm = cls(spatial_dimensions=2, ndim=2, **kw)
    tm.load_state_dict(from_flax(variables["params"],
                                 variables.get("batch_stats")))
    _step_pair(jm, variables, tm, _x((2, 32, 32, 1), seed=3), y, jloss,
               tloss, n_classes)


@pytest.mark.parametrize("net_type", ["vgg", "ord", "cat"])
def test_spatial_dimensions_2_on_volumes_matches_jax(net_type):
    """``spatial_dimensions: 2`` in a classification config: both
    factories build networks of the input's rank, 3D on volumes."""
    cfg = {"spatial_dimensions": 2, "first_depth": 4, "n_blocks": 2,
           "resnet_structure": STRUCTURE}
    n_classes = 3 if net_type == "ord" else 2
    jm = jget_network(net_type, cfg, n_classes=n_classes)
    x = _x((2, 32, 32, 16, 1), seed=4)
    variables = random_variables(jm, jnp.asarray(x), seed=5)
    tm = get_classification_network(net_type, cfg, n_classes=n_classes)
    tm.load_state_dict(from_flax(variables["params"],
                                 variables.get("batch_stats")))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    _close(got.numpy(), jm.apply(variables, jnp.asarray(x)), 1e-4)


def test_two_axis_pools_on_volumes_fail_in_both():
    cfg = {"spatial_dimensions": 2, "resnet_structure": STRUCTURE,
           "maxpool_structure": [[2, 2], [2, 2]]}
    with pytest.raises(ValueError, match="length-3"):
        jget_network("cat", cfg).init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 32, 32, 16, 1)))
    with pytest.raises(ValueError, match="length-3"):
        get_classification_network("cat", cfg)


def test_mil_attention_matches_jax():
    h = _x((2, 5, 6), seed=6)
    jm = JaxMILAttention(attention_dim=4)
    variables = random_variables(jm, jnp.asarray(h), seed=7)
    jpooled, jattn = jm.apply(variables, jnp.asarray(h))
    tm = MILAttention(6, attention_dim=4)
    tm.load_state_dict(from_flax(variables["params"]))
    with torch.no_grad():
        pooled, attn = tm(torch.from_numpy(h))
    _close(pooled.numpy(), jpooled, 1e-5)
    _close(attn.numpy(), jattn, 1e-5)
    np.testing.assert_allclose(attn.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("mil_method", ["standard", "transformer"])
@pytest.mark.parametrize("n_classes", [2, 3])
def test_mil_model_matches_jax(mil_method, n_classes):
    jm = jbuild_mil_model(MIL_CFG, mil_method, n_classes)
    x = _x(VOLUMES, seed=8)
    variables = random_variables(jm, jnp.asarray(x), seed=9)
    tm = build_mil_model(MIL_CFG, mil_method, n_classes)
    state = from_flax(variables["params"])
    assert set(state) == set(tm.state_dict())
    tm.load_state_dict(state)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert got.shape == (2, 1 if n_classes == 2 else n_classes)
    _close(got.numpy(), jm.apply(variables, jnp.asarray(x)), 1e-4)
    if n_classes == 2:
        y = np.asarray([0.0, 1.0], np.float32)
        jloss, tloss = jbinary_loss, tlosses.binary_logistic_loss
    else:
        from adell_mri_tpu.models.classification.losses import (
            cross_entropy_loss,
        )
        y = np.asarray([0, 2], np.float32)
        jloss, tloss = cross_entropy_loss, tlosses.cross_entropy_loss
    _step_pair(jm, variables, tm, _x(VOLUMES, seed=10), y, jloss, tloss,
               n_classes)
    if mil_method == "standard":
        jlog, jattn = jm.apply(variables, jnp.asarray(x),
                               return_attention=True)
        with torch.no_grad():
            tlog, tattn = tm(torch.from_numpy(x), return_attention=True)
        assert tattn.shape == (2, VOLUMES[3])
        _close(tattn.numpy(), jattn, 1e-4)
