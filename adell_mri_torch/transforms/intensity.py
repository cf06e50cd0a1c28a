"""
Device-side intensity transforms.

The port's copy of ``adell_mri_tpu/transforms/intensity.py``. Volumes are
channels-last ``[*S, C]``. Every random op is a draw from a
``torch.Generator`` on the volume's device followed by a deterministic
core that takes the draw (``truncate_kspace``, ``apply_bias_field``,
``contrast_gamma``, ``rician``, ``histogram_remap``,
``salt_and_pepper_at``, ``low_resolution_at``), so that a test can hand a
core JAX's draws. The ops compute in f32 and return the input's dtype.
Gamma, scale/shift and noise of the training step run batch-level on the
fused kernel (``ops/kernels/intensity.py``); the functions here serve the
augmentation policy's other ops and the TrivialAugment registry
(``transforms/augment.py``). None makes the host wait for the card.
"""

import numpy as np
import torch
import torch.nn.functional as F

from adell_mri_torch.models.layers.multi_resolution import resize_volume

# the smallest control-point gap jnp.interp treats as a step:
# np.spacing(eps) of f32
_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))


def _scalar(v, device):
    """``v`` (a number or a 0-dim tensor) as a f32 0-dim tensor on
    ``device``, without a host copy."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _uniform(generator, lo, hi, device, shape=()):
    u = torch.rand(shape, generator=generator, device=device)
    return lo + (hi - lo) * u


def scale_intensity(x, minv: float = 0.0, maxv: float = 1.0,
                    eps: float = 1e-6):
    """Min-max rescale to [minv, maxv] (ScaleIntensityd analogue)."""
    xf = x.float()
    lo, hi = xf.min(), xf.max()
    out = (xf - lo) / torch.clamp_min(hi - lo, eps) * (maxv - minv) + minv
    return out.to(x.dtype)


def conditional_rescale(x, max_value: float, scaling_factor: float):
    """Multiplies by ``scaling_factor`` only where the volume's max exceeds
    ``max_value`` (ConditionalRescalingd; ADC maps)."""
    xf = x.float()
    return torch.where(xf.max() > max_value, xf * scaling_factor,
                       xf).to(x.dtype)


def offset_intensity(x, offset=None):
    """Subtracts ``offset`` (by default the volume's min)."""
    xf = x.float()
    return (xf - (xf.min() if offset is None else offset)).to(x.dtype)


def normalize(x, eps: float = 1e-6):
    """Zero mean, unit (population) standard deviation."""
    xf = x.float()
    std = xf.std(correction=0)
    return ((xf - xf.mean()) / torch.clamp_min(std, eps)).to(x.dtype)


def scale_intensity_along_dim(x, axis: int = -2, eps: float = 1e-6):
    """Min-max scaling of each slice along ``axis`` (over every other axis,
    channels included; ScaleIntensityAlongDimd)."""
    xf = x.float()
    axes = tuple(d for d in range(x.dim()) if d != axis % x.dim())
    lo = xf.amin(dim=axes, keepdim=True)
    hi = xf.amax(dim=axes, keepdim=True)
    return ((xf - lo) / torch.clamp_min(hi - lo, eps)).to(x.dtype)


def gaussian_noise(generator, x, std=0.1, noise=None):
    """``x + std * noise``, ``noise`` standard normal (drawn when not
    given)."""
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device)
    return (x.float() + noise.float() * std).to(x.dtype)


def rician(x, n1, n2, std):
    """The Rician core: ``sqrt((x + std n1)^2 + (std n2)^2)``."""
    xf = x.float()
    return torch.sqrt((xf + n1 * std) ** 2 + (n2 * std) ** 2).to(x.dtype)


def rician_noise(generator, x, std=0.1):
    """MRI magnitude noise (RandRicianNoised)."""
    n1 = torch.randn(x.shape, generator=generator, device=x.device)
    n2 = torch.randn(x.shape, generator=generator, device=x.device)
    return rician(x, n1, n2, std)


def truncate_kspace(x, alpha):
    """The Gibbs core: keeps the share ``alpha`` (a number or a 0-dim
    tensor) of each spatial axis's centred spectrum, zeroes the rest."""
    ndim = x.dim() - 1
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


def gibbs_ringing(generator, x, alpha_range=(0.2, 0.8)):
    """Truncates high k-space frequencies of ``x`` [*S, C] (RandGibbsNoised
    analogue). ``alpha``, drawn uniformly from ``alpha_range``, is the
    fraction of the spectrum RETAINED, the inverse of MONAI's
    convention."""
    return truncate_kspace(
        x, _uniform(generator, alpha_range[0], alpha_range[1], x.device))


def draw_bias_grid(generator, x, grid_size: int = 4, magnitude=0.3):
    """The coarse log-field [g, ..., g, 1] of ``bias_field``: normal draws
    times ``magnitude``."""
    ndim = x.dim() - 1
    return torch.randn((grid_size,) * ndim + (1,), generator=generator,
                       device=x.device) * magnitude


def apply_bias_field(x, coarse):
    """The bias-field core: ``x * exp(field)``, the coarse log-field
    cubic-resized to the volume and broadcast over its channels (f32)."""
    field = resize_volume(coarse.float(), tuple(x.shape[:-1]) + (1,),
                          "cubic")
    return (x.float() * torch.exp(field)).to(x.dtype)


def bias_field(generator, x, grid_size: int = 4, magnitude=0.3):
    """Multiplicative smooth bias field (RandBiasFieldd analogue)."""
    return apply_bias_field(
        x, draw_bias_grid(generator, x, grid_size, magnitude))


def contrast_gamma(x, gamma, eps: float = 1e-6):
    """The contrast core: gamma on a [0, 1]-normalised copy, mapped back to
    the volume's range."""
    xf = x.float()
    lo, hi = xf.min(), xf.max()
    unit = (xf - lo) / torch.clamp_min(hi - lo, eps)
    return (unit ** gamma * (hi - lo) + lo).to(x.dtype)


def adjust_contrast(generator, x, gamma_range=(0.7, 1.5), eps: float = 1e-6):
    """Gamma contrast with ``gamma`` uniform in ``gamma_range``
    (RandAdjustContrastd)."""
    gamma = _uniform(generator, gamma_range[0], gamma_range[1], x.device)
    return contrast_gamma(x, gamma, eps)


def _gaussian_kernel1d(sigma, radius: int):
    """``2 radius + 1`` normalised Gaussian taps (f32) of ``sigma``, a
    number or a 0-dim tensor on the taps' device."""
    sigma = torch.clamp_min(sigma, 1e-3)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=sigma.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def smooth_axis(x, taps, axis: int):
    """Correlates f32 ``x`` with ``taps`` along ``axis``, zero padded:
    shifted slices summed, one fused multiply-add each (no convolution
    library, which would round to TF32 on the card)."""
    radius = (taps.shape[0] - 1) // 2
    n = x.shape[axis]
    # F.pad lists the last axis first
    pad = [0, 0] * (x.dim() - 1 - axis) + [radius, radius]
    xp = F.pad(x, pad)
    out = xp.narrow(axis, 0, n) * taps[0]
    for j in range(1, taps.shape[0]):
        out = torch.addcmul(out, xp.narrow(axis, j, n), taps[j])
    return out


def gaussian_smooth(x, sigma=1.0, radius: int = 3):
    """Separable Gaussian blur over the spatial axes, ``2 radius + 1``
    taps, zero padding, each channel on its own (RandGaussianSmoothd)."""
    taps = _gaussian_kernel1d(_scalar(sigma, x.device), radius)
    out = x.float()
    for d in range(x.dim() - 1):
        out = smooth_axis(out, taps, d)
    return out.to(x.dtype)


def random_gaussian_smooth(generator, x, sigma_range=(0.5, 1.5),
                           radius: int = 3):
    sigma = _uniform(generator, sigma_range[0], sigma_range[1], x.device)
    return gaussian_smooth(x, sigma, radius)


def sharpen(x, alpha=1.0, sigma=1.0):
    """Unsharp mask (RandGaussianSharpend analogue)."""
    xf = x.float()
    return (xf + alpha * (xf - gaussian_smooth(xf, sigma))).to(x.dtype)


def _linspace01(n: int, device):
    """``jnp.linspace(0, 1, n)`` in f32, its values bit for bit."""
    step = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    return torch.cat([step, torch.ones(1, device=device)])


def histogram_remap(x, jitter):
    """The histogram-shift core: the volume's [0, 1]-normalised values
    mapped through the control points ``linspace(0, 1, n) ->
    sort(jitter)`` with ends pinned to 0 and 1 (``jnp.interp``'s rules),
    then back to its range."""
    xf = x.float()
    lo, hi = xf.min(), xf.max()
    unit = (xf - lo) / torch.clamp_min(hi - lo, 1e-6)
    n = jitter.shape[0]
    ref = _linspace01(n, x.device)
    pts = torch.sort(jitter.float()).values
    pts = torch.cat([torch.zeros(1, device=x.device), pts[1:-1],
                     torch.ones(1, device=x.device)])
    i = torch.searchsorted(ref, unit.reshape(-1), right=True)
    i = i.clamp(1, n - 1).reshape(unit.shape)
    df = pts[i] - pts[i - 1]
    dx = ref[i] - ref[i - 1]
    delta = unit - ref[i - 1]
    dx0 = dx.abs() <= _INTERP_EPS
    f = torch.where(dx0, pts[i - 1],
                    pts[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(unit < ref[0], pts[0], f)
    f = torch.where(unit > ref[-1], pts[-1], f)
    return (f * (hi - lo) + lo).to(x.dtype)


def histogram_shift(generator, x, num_control_points: int = 10):
    """Random monotone intensity remap through control points
    (RandHistogramShiftd analogue)."""
    jitter = torch.rand((num_control_points,), generator=generator,
                        device=x.device)
    return histogram_remap(x, jitter)


def low_resolution_at(x, zoom):
    """The low-resolution core: a Gaussian smoothing with sigma =
    clip(1 / zoom - 1, 0, 3), the JAX package's approximation of a down-
    and up-sampling (zoom >= 1 leaves the volume as it is)."""
    sigma = torch.clamp(1.0 / _scalar(zoom, x.device) - 1.0, 0.0, 3.0)
    return gaussian_smooth(x, sigma)


def low_resolution(generator, x, zoom_range=(0.5, 1.0)):
    """Simulated low resolution (RandSimulateLowResolutiond analogue) with
    ``zoom`` uniform in ``zoom_range``."""
    zoom = _uniform(generator, zoom_range[0], zoom_range[1], x.device)
    return low_resolution_at(x, zoom)


def salt_and_pepper_at(x, noise, prob: float = 0.01):
    """The salt-and-pepper core: voxels whose uniform ``noise`` is below
    ``prob / 2`` take the min, above ``1 - prob / 2`` the max."""
    xf = x.float()
    lo, hi = xf.min(), xf.max()
    xf = torch.where(noise < prob / 2, lo, xf)
    return torch.where(noise > 1 - prob / 2, hi, xf).to(x.dtype)


def salt_and_pepper(generator, x, prob: float = 0.01):
    noise = torch.rand(x.shape, generator=generator, device=x.device)
    return salt_and_pepper_at(x, noise, prob)
