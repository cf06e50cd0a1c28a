"""
Device-side intensity transforms of the ported augmentation policy.

Counterpart of ``gibbs_ringing`` in ``adell_mri_tpu/transforms/intensity.py``.
The bias field, Gaussian smoothing and low-resolution simulation are not
ported yet. Gamma, scale/shift and noise run batch-level on the fused
kernel (``ops/kernels/intensity.py``).
"""

import torch


def gibbs_ringing(generator, x, alpha_range=(0.2, 0.8)):
    """Truncates high k-space frequencies of ``x`` [*S, C] (RandGibbsNoised
    analogue). ``alpha``, drawn uniformly from ``alpha_range``, is the
    fraction of the spectrum RETAINED, the inverse of MONAI's
    convention."""
    ndim = x.dim() - 1
    u = torch.rand((), generator=generator, device=x.device)
    alpha = alpha_range[0] + (alpha_range[1] - alpha_range[0]) * u
    axes = tuple(range(ndim))
    k = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=axes), dim=axes)
    mask = torch.ones((), dtype=torch.bool, device=x.device)
    for d in range(ndim):
        n = x.shape[d]
        freq = (torch.arange(n, device=x.device) - n / 2).abs() / (n / 2)
        shape = [1] * x.dim()
        shape[d] = n
        mask = mask & (freq <= alpha).reshape(shape)
    k = torch.where(mask, k, torch.zeros((), dtype=k.dtype, device=x.device))
    out = torch.fft.ifftn(torch.fft.ifftshift(k, dim=axes), dim=axes)
    return out.real.to(x.dtype)
