"""
The Gaussian-process output layer of an SNGP-style classifier.

Counterpart of ``adell_mri_tpu/models/layers/gaussian_process.py``:
``GaussianProcessLayer`` maps its input through fixed random Fourier
features ``phi = sqrt(2 / n) cos(x w + b)`` and a bias-free Dense layer
``beta`` to logits; ``fit_covariance`` is the Laplace covariance
``(Phi^T Phi + ridge I)^-1`` over a dataset's features, fitted after
training, and ``predictive_logits`` the mean-field correction
``logits / sqrt(1 + (pi / 8) var)`` with ``var = phi cov phi^T``.

The JAX layer draws ``w`` (normal, ``[in, n] / length_scale``) and ``b``
(uniform in ``[0, 2 pi)``) inside every call from fixed PRNG keys. Here
they are persistent buffers, so a checkpoint carries them: a fresh layer
draws them from seeded ``torch.Generator``s, and ``from_flax`` takes the
JAX draws beside the JAX parameters. They stay f32 under the bf16 policy,
as the JAX constants are f32 and promote the product: ``phi`` and the
logits are f32.
"""

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from adell_mri_torch.ops.conv import lecun_normal_


class GaussianProcessLayer(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 n_random_features: int = 256, length_scale: float = 2.0):
        super().__init__()
        self.n_random_features = n_random_features
        w = torch.randn(in_features, n_random_features,
                        generator=torch.Generator().manual_seed(0))
        b = torch.rand(n_random_features,
                       generator=torch.Generator().manual_seed(1))
        self.register_buffer("w", w / length_scale)
        self.register_buffer("b", b * (2 * math.pi))
        self.beta = nn.Linear(n_random_features, out_features, bias=False)
        lecun_normal_(self.beta.weight, n_random_features)

    def forward(self, x, return_phi: bool = False):
        """Logits [..., out] (f32), and with ``return_phi`` the random
        features [..., n] (f32) as well."""
        dtype = torch.promote_types(x.dtype, self.w.dtype)
        with _f32_products():
            phi = (math.sqrt(2.0 / self.n_random_features)
                   * torch.cos(x.to(dtype) @ self.w.to(dtype)
                               + self.b.to(dtype)))
            logits = F.linear(phi, self.beta.weight.to(phi.dtype))
        return (logits, phi) if return_phi else logits


@contextlib.contextmanager
def _f32_products():
    """cuBLAS's f32 products without TF32 within the block (the JAX
    functions' products are f32)."""
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed


def fit_covariance(phis: torch.Tensor, ridge: float = 1.0) -> torch.Tensor:
    """``(Phi^T Phi + ridge I)^-1`` over the features ``phis`` [N, n], in
    their dtype."""
    d = phis.shape[-1]
    eye = torch.eye(d, dtype=phis.dtype, device=phis.device)
    with _f32_products():
        return torch.linalg.inv(phis.T @ phis + ridge * eye)


def predictive_logits(logits: torch.Tensor, phi: torch.Tensor,
                      covariance: torch.Tensor,
                      mean_field_factor: float = math.pi / 8):
    """``logits / sqrt(1 + mean_field_factor * var)``, ``var`` the
    predictive variance ``sum((phi @ cov) * phi, -1)`` of each row."""
    with _f32_products():
        var = torch.sum((phi @ covariance) * phi, dim=-1, keepdim=True)
    return logits / torch.sqrt(1.0 + mean_field_factor * var)
