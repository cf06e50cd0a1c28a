"""
Fused intensity augmentation on a hand-written Hopper kernel.

Counterpart of ``adell_mri_tpu/ops/pallas/intensity.py``: the CUDA kernel
in ``adell_mri_torch/csrc/intensity_aug.cu`` replaces that module's
``_batch_kernel`` (per-sample parameters, K3) and, called with B=1,
``_kernel`` (scalar parameters, K2). One pass over the batch applies gamma
contrast, scale/shift and Gaussian or Rician noise; the noise comes from a
Philox generator inside the kernel, keyed by a seed drawn on the device.

``intensity_aug`` launches the kernel for CUDA tensors and runs the plain
version, ``intensity_aug_reference``, only for CPU tensors. The plain
version draws the kernel's own stream (``philox_normals``: Philox4x32-10
in torch integer arithmetic, the kernel's counter layout, uniform map and
Box-Muller), so the two agree element by element, noise included.

``fused_intensity_aug_batch`` draws the per-sample parameters and gates
and computes lo/hi (and the std under ``std_shift``) with torch
reductions outside the kernel, as XLA does outside the Pallas kernel;
``fused_intensity_aug`` is the scalar-parameter call.
"""

import torch

from adell_mri_torch.ops.kernels.build import load_library

_LAUNCHERS = {
    torch.bfloat16: "adell_intensity_aug_bf16",
    torch.float32: "adell_intensity_aug_f32",
}
#: elements per 16-byte vector of each dtype; a sample's element count must
#: be a multiple of it (the TPU kernel needs a multiple of 128)
_VEC = {torch.bfloat16: 8, torch.float32: 4}
_SEED_MAX = 2**62


_MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
#: float32(2 pi): the Box-Muller angle is 2 pi u2
_TWO_PI = 6.2831854820251465


def _mulhilo(m: int, c):
    """High and low words of the 32x32->64 product of the constant ``m``
    and int64 words ``c`` in [0, 2^32): ``m`` in 16-bit halves, so that
    no partial product reaches 2^63."""
    p_lo = c * (m & 0xFFFF)
    p_hi = c * (m >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 (Random123): ``counter`` int64 [..., 4] and ``key``
    int64 [..., 2], 32-bit words in int64, broadcast against each other;
    returns the four output words as int64 [..., 4]."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key.unbind(-1)
    for _ in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W[0]) & _MASK32
        k1 = (k1 + PHILOX_W[1]) & _MASK32
    return torch.stack(torch.broadcast_tensors(c0, c1, c2, c3), -1)


def philox_key(seed, device):
    """The kernel's Philox key of ``seed`` (an int or a one-element int64
    tensor): its low and high 32-bit words, int64 [2] on ``device``."""
    s = torch.as_tensor(seed, dtype=torch.int64).reshape(-1)[:1].to(device)
    return torch.cat([s & _MASK32, (s >> 32) & _MASK32])


def uniform01(bits):
    """32-bit words (int64) -> f32 uniforms in [0, 1) through the
    mantissa: ``(bits >> 9) | 1.0f``, minus 1, as the kernel."""
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return one - 1.0


def philox_uniforms(seed, batch: int, groups: int, draw: int, device):
    """The kernel's uniforms, f32 [batch, groups, 4]: ``uniform01`` of the
    words of the Philox call at counter (group, 0, sample, draw) with
    ``philox_key(seed)``."""
    g = torch.arange(groups, dtype=torch.int64, device=device)
    s = torch.arange(batch, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    counter = torch.stack(torch.broadcast_tensors(
        g[None, :], zero, s[:, None], zero + draw), -1)
    return uniform01(philox4x32_10(counter, philox_key(seed, device)))


def philox_normals(seed, batch: int, n: int, draw: int, device):
    """The kernel's standard normals, f32 [batch, n]: element e of sample
    b is normal e % 4 of the Philox call at counter (e // 4, 0, b, draw);
    its uniforms (u0, u1, u2, u3) give the Box-Muller pairs (u0, u1) and
    (u2, u3), the first of a pair clamped at 1e-12, each pair sqrt(-2 ln
    u) times (cos, sin) of 2 pi u'."""
    groups = -(-n // 4)
    u = philox_uniforms(seed, batch, groups, draw, device)
    rad = torch.sqrt(-2.0 * torch.log(u[..., 0::2].clamp_min(1e-12)))
    angle = u[..., 1::2] * _TWO_PI
    normals = torch.stack([rad * torch.cos(angle), rad * torch.sin(angle)],
                          -1)
    return normals.reshape(batch, groups * 4)[:, :n]


def intensity_aug_reference(seed, x, par, rician: bool, noise: bool):
    """Plain PyTorch version of the kernel: x [B, ...], par [B, 6] =
    (lo, hi, gamma, scale, shift, sigma); f32 arithmetic, output in x's
    dtype. ``seed`` (an int or the kernel's one-element int64 tensor) is
    the Philox key of the kernel's noise (``philox_normals``)."""
    b = x.shape[0]
    xf = x.float().reshape(b, -1)
    lo, hi, gamma, scale, shift, sigma = par.float().t().unsqueeze(-1)
    span = (hi - lo).clamp_min(1e-6)
    unit = ((xf - lo) / span).clamp_min(1e-6)
    unit = torch.exp(gamma * torch.log(unit))
    out = (unit * span + lo) * scale + shift
    if noise:
        n = xf.shape[1]
        n1 = philox_normals(seed, b, n, 0, x.device)
        if rician:
            n2 = philox_normals(seed, b, n, 1, x.device)
            mag = torch.sqrt((out + sigma * n1) ** 2 + (sigma * n2) ** 2)
            out = torch.where(sigma > 0, mag, out)
        else:
            out = out + sigma * n1
    return out.reshape(x.shape).to(x.dtype)


def _check(x, par, seed):
    if x.dtype not in _LAUNCHERS:
        raise TypeError(f"intensity_aug takes bf16 or f32, got {x.dtype}")
    if x.dim() < 2 or x.shape[0] == 0:
        raise ValueError(
            f"x must be [B, ...] with B > 0, got {tuple(x.shape)}"
        )
    n = x[0].numel()
    if x.shape[0] > 65535 or n >= 2**31:
        raise ValueError(
            f"intensity_aug takes at most 65535 samples of fewer than 2^31 "
            f"elements, got {x.shape[0]} of {n}"
        )
    if n % _VEC[x.dtype]:
        raise ValueError(
            f"intensity_aug needs a per-sample element count that is a "
            f"multiple of {_VEC[x.dtype]} for {x.dtype}, got {n}"
        )
    if tuple(par.shape) != (x.shape[0], 6) or par.dtype != torch.float32:
        raise ValueError(
            f"par must be f32 [{x.shape[0]}, 6], got {par.dtype} "
            f"{tuple(par.shape)}"
        )
    if seed.dtype != torch.int64 or seed.numel() != 1:
        raise ValueError("seed must be a one-element int64 tensor")
    for name, t in (("x", x), ("par", par), ("seed", seed)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")


def intensity_aug(seed, x, par, rician: bool = True, noise: bool = True):
    """One fused pass: x [B, ...] (bf16 or f32), par [B, 6] f32 on x's
    device, ``seed`` a one-element int64 tensor on x's device (the Philox
    key). ``noise`` and ``rician`` are compile-time switches of the kernel,
    as the TPU kernel's static arguments. CUDA tensors launch the kernel;
    CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return intensity_aug_reference(seed, x, par, rician, noise)
    if x.device.type != "cuda":
        raise ValueError(f"intensity_aug runs on cuda or cpu, not {x.device}")
    _check(x, par, seed)
    out = torch.empty_like(x)
    launcher = getattr(load_library(), _LAUNCHERS[x.dtype])
    with torch.cuda.device(x.device):
        n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = launcher(
            x.data_ptr(), out.data_ptr(), par.data_ptr(), seed.data_ptr(),
            x.shape[0], x[0].numel(), int(noise), int(rician), n_sm, stream,
        )
    if rc != 0:
        raise RuntimeError(f"intensity_aug launch failed: cudaError {rc}")
    intensity_aug.launches += 1
    return out


#: kernel launches since the last reset (set to 0 to start a count)
intensity_aug.launches = 0


def fused_intensity_aug(
    seed, x, lo, hi, gamma=1.0, scale=1.0, shift=0.0, sigma=0.0,
    rician: bool = False,
):
    """The scalar-parameter chain over one volume (K2): the kernel at B=1.
    ``seed`` is an int or a one-element int64 tensor; the parameters are
    numbers or scalar tensors. A sigma that is not above 0 turns the noise
    off: a Rician magnitude would rectify negative voxels."""
    noise = float(sigma) > 0.0
    par = torch.tensor(
        [[float(v) for v in (lo, hi, gamma, scale, shift, sigma)]],
        dtype=torch.float32, device=x.device,
    )
    seed = torch.tensor([int(seed)], dtype=torch.int64, device=x.device)
    out = intensity_aug(
        seed, x.reshape(1, -1), par, rician=rician and noise, noise=noise
    )
    fused_intensity_aug.launches += x.device.type == "cuda"
    return out.reshape(x.shape)


#: B=1 launches through this call since the last reset (each also counts
#: in ``intensity_aug.launches``)
fused_intensity_aug.launches = 0


def fused_intensity_aug_batch(
    generator,
    x,
    gamma_range=(0.7, 1.5),
    scale_delta: float = 0.1,
    shift_delta: float = 0.1,
    sigma: float = 0.0,
    rician: bool = True,
    gamma_prob: float = 1.0,
    shift_prob: float = 1.0,
    noise_prob: float = 1.0,
    std_shift: bool = False,
):
    """Batch-level gamma contrast + scale/shift + noise with per-sample
    random parameters, drawn from ``generator`` (on x's device); x
    [B, *S, C]. Each ``*_prob`` fires its op per sample; a sample where an
    op does not fire gets that op's identity parameters. ``std_shift``
    scales the shift by the sample's standard deviation. One kernel
    launch on the card."""
    b, dev = x.shape[0], x.device

    def uniform(lo, hi):
        u = torch.rand((b,), generator=generator, device=dev)
        return lo + (hi - lo) * u

    def gate(prob):
        return torch.rand((b,), generator=generator, device=dev) < prob

    gamma = uniform(*gamma_range)
    scale = 1.0 + uniform(-scale_delta, scale_delta)
    shift = uniform(-shift_delta, shift_delta)
    red = tuple(range(1, x.dim()))
    lo = x.amin(dim=red).float()
    hi = x.amax(dim=red).float()
    if std_shift:
        shift = shift * x.float().std(dim=red, correction=0)
    if gamma_prob < 1.0:
        gamma = torch.where(gate(gamma_prob), gamma, 1.0)
    if shift_prob < 1.0:
        fire = gate(shift_prob)
        scale = torch.where(fire, scale, 1.0)
        shift = torch.where(fire, shift, 0.0)
    sig = torch.full((b,), float(sigma), device=dev)
    if noise_prob < 1.0:
        sig = torch.where(gate(noise_prob), sig, 0.0)
    par = torch.stack([lo, hi, gamma, scale, shift, sig], dim=1)
    # the Philox key, drawn on the device: no host sync
    seed = torch.randint(0, _SEED_MAX, (1,), generator=generator,
                         device=dev, dtype=torch.int64)
    return intensity_aug(
        seed, x.contiguous(), par.contiguous(), rician=rician,
        noise=sigma > 0,
    )
