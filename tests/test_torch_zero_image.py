"""
A bf16 training step of the U-Net encoder classifier on an all-zero
image (what ``--image_masking`` by an empty mask feeds it), on the CPU.

Both packages, on the same seeded weights (instance norms, swish, the
sample yaml's dropout 0.15, four stages at 32x32x16, B=2), give
non-finite gradients in bf16 and finite ones in f32: the fault is not
the port's. With the yaml's own five stages at 32^3 the port's finite
bf16 gradients reach 1e34 where the f32 ones stay below 2e3, and
anomaly detection names the instance norm's ``x - mean`` as the first
backward to return NaN. The likely mechanism (not verified op by op):
on an all-zero image every map is a constant plus rounding, each
instance norm of such a map scales by about ``rsqrt(eps)``, and bf16's
rounding (2^-8 of the constant, against f32's 2^-24) gives the maps
deviations large enough for the stack of norms to overflow. The two
packages round differently on the way (XLA fuses the norm's bf16
operations), so which leaves overflow differs: at dropout 0 the JAX
step still overflows (6 leaves) where the port's stays finite; that
case is rounding luck and is not pinned.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.models.classification import losses as jlosses
from adell_mri_tpu.train import steps as jsteps
from adell_mri_torch.models.classification import losses as tlosses
from adell_mri_torch.models.layers import adn as tadn
from adell_mri_torch.train import steps as tsteps
from test_torch_vit_classifier import build

SHAPE = (32, 32, 16)


def _nonfinite(precision, dropout):
    """The number of gradient leaves with a non-finite element, JAX's and
    the port's."""
    depth = [8, 16, 32, 64]
    cfg = dict(depth=depth, conv_type="resnet", link_type="residual",
               upscale_type="transpose", norm_type="instance",
               activation_fn="swish", dropout_param=dropout,
               strides=[2] * 4, kernel_sizes=[3] * 4)
    x = np.random.default_rng(0).uniform(size=(2,) + SHAPE + (1,))
    jm, params, bs, tm = build("unet", cfg, 2, x.astype(np.float32),
                               seed=61, batch_stats=True)
    batch = {"image": np.zeros((2,) + SHAPE + (1,), np.float32),
             "label": np.asarray([0, 1], np.float32)}
    jlm = jsteps.make_classification_step(
        jm, jlosses.binary_logistic_loss, precision=precision)
    _, jgrads = jax.jit(jax.value_and_grad(jlm, has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(2),
        variables={"batch_stats": bs})
    tlm = tsteps.make_classification_step(
        tm, tlosses.binary_logistic_loss, precision=precision)
    tparams = dict(tm.named_parameters())
    torch.manual_seed(0)  # the port's dropout draws
    loss, _ = tlm({**tparams, **tadn.batch_stats(tm)},
                  {k: torch.from_numpy(v) for k, v in batch.items()})
    tgrads = torch.autograd.grad(loss, list(tparams.values()),
                                 allow_unused=True)
    return (sum(not np.isfinite(np.asarray(g)).all()
                for g in jax.tree.leaves(jgrads)),
            sum(g is not None and not bool(torch.isfinite(g).all())
                for g in tgrads))


@pytest.mark.parametrize("precision, nonfinite", [("bf16", True),
                                                  (None, False)])
def test_zero_image_step_is_pinned_on_both_sides(precision, nonfinite):
    jax_bad, port_bad = _nonfinite(precision, 0.15)
    assert (jax_bad > 0) == nonfinite, jax_bad
    assert (port_bad > 0) == nonfinite, port_bad
