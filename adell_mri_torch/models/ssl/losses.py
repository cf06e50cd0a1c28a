"""
Self-supervised losses.

Counterpart of every loss in ``adell_mri_tpu/models/ssl/losses.py``
(``cosine_similarity``, ``simsiam_loss``, ``byol_loss``, ``vicreg_loss``,
``vicregl_loss``, ``barlow_twins_loss``, ``ntxent_loss``,
``sinkhorn_knopp``, ``dino_loss``, ``koleo_loss``,
``contrastive_distance_loss``, ``kl_divergence_loss``, ``mae_loss`` and
``ijepa_loss``), over the batch one card holds
(the JAX functions' ``axis_name`` reduces over several chips; one chip
needs none). Each target of a stop-gradient loss is detached. VICReg
divides its variance and covariance by ``n - 1``, written out as the JAX
function writes it; Barlow Twins standardises by the biased standard
deviation, as ``jnp.std`` computes it (``torch.std`` defaults to the
unbiased one), from the same centred values. VICRegL keeps, of each
local feature's nearest match, the ``top_k`` spatially closest by a
stable sort of the distances: the lower index first among equal ones, the
order ``jax.lax.top_k`` gives (``torch.topk`` does not order ties).
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


def vicregl_loss(z1, z2, local1, local2, coords1, coords2,
                 alpha: float = 0.75, top_k: int = 4, **vicreg_kwargs):
    """VICRegL: ``alpha`` x VICReg of the global projections + (1 -
    ``alpha``) x the local term. ``local*`` [B, N, F] local features,
    ``coords*`` [B, N, d] their positions in the input volume; each
    feature is matched with the other view's nearest by position (the
    first among equals), and the feature MSE of the ``top_k`` spatially
    closest matches is averaged, both ways. Returns (total, components
    with ``local``)."""
    g_total, g_comp = vicreg_loss(z1, z2, **vicreg_kwargs)

    def match(a_feat, a_xy, b_feat, b_xy):
        d = torch.sum((a_xy[:, :, None, :] - b_xy[:, None, :, :]) ** 2, -1)
        nn_dist = torch.amin(d, dim=-1)
        nn_idx = torch.argmin(d, dim=-1)
        b_matched = torch.gather(
            b_feat, 1, nn_idx[..., None].expand(-1, -1, b_feat.shape[-1]))
        pair_mse = torch.mean((a_feat - b_matched) ** 2, dim=-1)
        k = min(top_k, pair_mse.shape[1])
        best_idx = torch.sort(nn_dist, dim=1, stable=True)[1][:, :k]
        return torch.mean(torch.gather(pair_mse, 1, best_idx))

    local = (match(local1, coords1, local2, coords2)
             + match(local2, coords2, local1, coords1))
    total = alpha * g_total + (1 - alpha) * local
    return total, {**g_comp, "local": local}


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


def sinkhorn_knopp(scores, n_iter: int = 3, eps: float = 0.05):
    """Sinkhorn-Knopp normalisation of teacher scores [B, K]: ``n_iter``
    rounds of prototype (row) then sample (column) normalisation of
    ``exp(scores / eps)``; returns [B, K] assignments summing to 1 a
    sample."""
    q = torch.exp(scores / eps).t()
    q = q / torch.sum(q)
    k, b = q.shape
    for _ in range(n_iter):
        q = q / torch.sum(q, dim=1, keepdim=True).clamp_min(1e-12) / k
        q = q / torch.sum(q, dim=0, keepdim=True).clamp_min(1e-12) / b
    return (q * b).t()


def dino_loss(student_logits, teacher_logits, center,
              student_temp: float = 0.1, teacher_temp: float = 0.04,
              center_momentum: float = 0.9, use_sinkhorn: bool = False):
    """DINO's cross-entropy between the student's log-probabilities and
    the detached teacher's centred, sharpened probabilities (or its
    Sinkhorn-Knopp assignments). Returns (loss, the centre moved towards
    the teacher's batch mean)."""
    teacher = teacher_logits.detach()
    if use_sinkhorn:
        t_probs = sinkhorn_knopp(teacher)
    else:
        t_probs = torch.softmax((teacher - center) / teacher_temp, dim=-1)
    s_logp = torch.log_softmax(student_logits / student_temp, dim=-1)
    loss = -torch.mean(torch.sum(t_probs * s_logp, dim=-1))
    new_center = (center * center_momentum
                  + torch.mean(teacher, dim=0) * (1 - center_momentum))
    return loss, new_center


def koleo_loss(z, eps: float = 1e-8):
    """The Kozachenko-Leonenko entropy term: minus the mean log distance
    of each normalised feature to its nearest neighbour."""
    z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(eps)
    d = torch.sum((z[:, None, :] - z[None, :, :]) ** 2, -1)
    d = d + torch.eye(z.shape[0], dtype=d.dtype, device=d.device) * 1e9
    nn_d = torch.sqrt(torch.min(d, dim=-1)[0].clamp_min(eps))
    return -torch.mean(torch.log(nn_d + eps))


def contrastive_distance_loss(z1, z2, labels, margin: float = 1.0):
    """The siamese contrastive loss: squared distance for pairs labelled
    1, squared hinge of ``margin`` minus the distance for pairs labelled
    0."""
    d = torch.sqrt(torch.sum((z1 - z2) ** 2, -1).clamp_min(1e-12))
    pos = labels * d ** 2
    neg = (1 - labels) * F.relu(margin - d) ** 2
    return torch.mean(pos + neg)


def kl_divergence_loss(p_logits, q_logits):
    """KL(softmax(p) || softmax(q)), summed over classes, averaged over
    the rest."""
    p = torch.softmax(p_logits, -1)
    return torch.mean(torch.sum(
        p * (torch.log_softmax(p_logits, -1)
             - torch.log_softmax(q_logits, -1)), dim=-1))


def mae_loss(pred_patches, target_patches, mask):
    """The patch MSE averaged over the masked patches (``mask`` [B, N], 1
    = masked)."""
    per = torch.mean((pred_patches - target_patches) ** 2, dim=-1)
    mask = mask.to(per.dtype)
    return torch.sum(per * mask) / torch.clamp(torch.sum(mask), min=1.0)
