"""
The port's ``resize_like`` against ``jax.image.resize`` (what the JAX
package's ``resize_like`` calls), on the CPU, f32, 1e-6 absolute on inputs
of unit scale: the weights are built the same way and only the summation
order differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adell_mri_tpu.models.layers.multi_resolution import (
    resize_like as jax_resize_like,
)
from adell_mri_torch.models.layers.multi_resolution import (
    linear_resize_weights,
    resize_like,
)

X = np.random.default_rng(0).normal(size=(2, 8, 6, 10, 3)).astype(np.float32)


@pytest.mark.parametrize(
    "target, method",
    [
        ((8, 6, 5), "linear"),     # 2x shrink of one axis (antialiased)
        ((4, 3, 5), "linear"),     # 2x shrink of all axes
        ((5, 4, 7), "linear"),     # non-integer ratios
        ((16, 9, 20), "linear"),   # enlargement
        ((16, 6, 5), "linear"),    # one axis up, one down, one kept
        ((4, 9, 7), "nearest"),
        ((8, 6, 10), "linear"),    # nothing changes
    ],
)
def test_resize_like_matches_jax(target, method):
    want = np.asarray(jax_resize_like(jnp.asarray(X), target, method=method))
    got = resize_like(torch.from_numpy(X), target, method=method).numpy()
    assert got.shape == want.shape == (2,) + target + (3,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_two_fold_shrink_weighs_four_neighbours():
    """The antialiased 2x shrink is (1/8, 3/8, 3/8, 1/8) inside and
    renormalised at the edges, not the two-tap mean of a plain linear
    interpolation."""
    w = linear_resize_weights(8, 4).numpy()
    np.testing.assert_allclose(w[1:5, 1], [1 / 8, 3 / 8, 3 / 8, 1 / 8])
    np.testing.assert_allclose(w[:3, 0], [3 / 7, 3 / 7, 1 / 7], rtol=1e-6)
    np.testing.assert_allclose(w.sum(0), 1.0, rtol=1e-6)


def test_resize_like_2d_and_dtype():
    x = np.random.default_rng(1).normal(size=(1, 9, 7, 2)).astype(np.float32)
    want = np.asarray(
        jax.image.resize(jnp.asarray(x), (1, 4, 14, 2), method="linear")
    )
    got = resize_like(torch.from_numpy(x), (4, 14))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert resize_like(torch.from_numpy(x).bfloat16(), (4, 14)).dtype == (
        torch.bfloat16
    )


def test_resize_like_refuses_bad_arguments():
    x = torch.zeros((1, 4, 4, 4, 1))
    with pytest.raises(ValueError):
        resize_like(x, (2, 2))
    # cubic and lanczos are ported (tests/test_torch_unet_options.py);
    # a name jax.image.resize does not take still raises
    with pytest.raises(NotImplementedError):
        resize_like(x, (2, 2, 2), method="area")
