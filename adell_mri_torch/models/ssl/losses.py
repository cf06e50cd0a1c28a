"""
Self-supervised losses.

Counterpart of ``cosine_similarity``, ``simsiam_loss``, ``byol_loss``,
``vicreg_loss``, ``barlow_twins_loss``, ``ntxent_loss`` and ``ijepa_loss``
in ``adell_mri_tpu/models/ssl/losses.py``, over the batch one card holds
(the JAX functions' ``axis_name`` reduces over several chips; one chip
needs none). Each target of a stop-gradient loss is detached. VICReg
divides its variance and covariance by ``n - 1``, written out as the JAX
function writes it; Barlow Twins standardises by the biased standard
deviation, as ``jnp.std`` computes it (``torch.std`` defaults to the
unbiased one), from the same centred values.
"""

import torch
import torch.nn.functional as F


def cosine_similarity(a, b, eps: float = 1e-8):
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True).clamp_min(eps)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True).clamp_min(eps)
    return torch.sum(a * b, dim=-1)


def simsiam_loss(pred, target):
    """Negative cosine against the detached target."""
    return -torch.mean(cosine_similarity(pred, target.detach()))


def byol_loss(pred, target):
    """``2 - 2 cos`` against the detached target."""
    return torch.mean(2.0 - 2.0 * cosine_similarity(pred, target.detach()))


def _vicreg_side(z, gamma: float, eps: float):
    n = z.shape[0]
    zc = z - torch.mean(z, dim=0)
    var = torch.sum(zc ** 2, dim=0) / max(n - 1, 1)
    cov = (zc.t() @ zc) / max(n - 1, 1)
    std = torch.sqrt(var + eps)
    var_loss = torch.mean(F.relu(gamma - std))
    off_diag = cov - torch.diag(torch.diag(cov))
    return var_loss, torch.sum(off_diag ** 2) / z.shape[-1]


def vicreg_loss(z1, z2, lam: float = 25.0, mu: float = 25.0,
                nu: float = 0.1, gamma: float = 1.0, eps: float = 1e-4):
    """VICReg: ``lam`` x invariance (the MSE of the two sides) + ``mu`` x
    the variance hinge + ``nu`` x the off-diagonal covariance, the last
    two averaged over the sides. Returns (total, components)."""
    v1, c1 = _vicreg_side(z1, gamma, eps)
    v2, c2 = _vicreg_side(z2, gamma, eps)
    inv = torch.mean((z1 - z2) ** 2)
    var_loss = (v1 + v2) / 2
    cov_loss = (c1 + c2) / 2
    total = lam * inv + mu * var_loss + nu * cov_loss
    return total, {"invariance": inv, "variance": var_loss,
                   "covariance": cov_loss}


def barlow_twins_loss(z1, z2, lam: float = 5e-3, eps: float = 1e-5):
    """The cross-correlation of the standardised sides held to the
    identity."""
    n = z1.shape[0]

    def standardise(z):
        # the standard deviation from the same centred values, as jnp.std
        # takes it: torch.std's backward centres again, and where the
        # deviation is small the two centrings' roundings no longer cancel
        zc = z - z.mean(0)
        return zc / torch.sqrt(torch.mean(zc * zc, dim=0)).clamp_min(eps)

    c = (standardise(z1).t() @ standardise(z2)) / n
    diag = torch.diag(c)
    return (torch.sum((diag - 1.0) ** 2)
            + lam * (torch.sum(c ** 2) - torch.sum(diag ** 2)))


def ntxent_loss(z1, z2, temperature: float = 1.0, eps: float = 1e-8,
                apply_relu: bool = True):
    """SimCLR's NT-Xent over the batch: sample i's positive is i + n."""
    if apply_relu:
        z1, z2 = F.relu(z1), F.relu(z2)
    z = torch.cat([z1, z2], dim=0)
    z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(eps)
    n = z1.shape[0]
    sim = z @ z.t() / temperature
    eye = torch.eye(2 * n, dtype=torch.bool, device=z.device)
    sim = torch.where(eye, torch.full_like(sim, -1e9), sim)
    idx = torch.arange(n, device=z.device)
    targets = torch.cat([idx + n, idx])
    logp = torch.log_softmax(sim, dim=-1)
    return -torch.mean(logp[torch.arange(2 * n, device=z.device), targets])


def ijepa_loss(pred_features, target_features, mask=None):
    """The squared error against the detached target features, averaged
    over the masked positions (``mask`` [B, N], 1 = target) and the
    feature axis; over everything without a mask."""
    err = (pred_features - target_features.detach()) ** 2
    if mask is None:
        return torch.mean(err)
    w = mask[..., None].to(err.dtype)
    return torch.sum(err * w) / torch.clamp(
        torch.sum(w) * pred_features.shape[-1], min=1.0)
