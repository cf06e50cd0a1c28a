"""
Blockwise (flash) softmax attention on hand-written Hopper kernels.

Counterpart of ``adell_mri_tpu/ops/pallas/attention.py``. The three CUDA
kernels in ``adell_mri_torch/csrc/flash_attention.cu`` replace its four
Pallas kernels:

- ``flash_attention_fwd`` replaces ``_flash_kernel_vmem`` and
  ``_flash_kernel`` (one function; the first was a TPU workaround) and
  returns ``(out, m, l)``: the output and the online-softmax row maximum
  and row sum, which the backward (and a later ring combination) consume;
- ``flash_attention_bwd_dq`` replaces ``_bwd_dq_kernel``;
- ``flash_attention_bwd_dkv`` replaces ``_bwd_dkv_kernel``.

q is ``[B, H, Nq, D]``, k and v ``[B, H, Nkv, D]``; ``Nq`` may differ from
``Nkv``; there is no mask and no causal option. The N x N matrix is never
written to device memory. All three are bound by operations on the H100
(about 1000 FLOP per byte at ``[1, 8, 2048, 64]`` in bf16, against the
card's ridge of 295): the least times there are 8.7 us, 13.0 us and
17.4 us at 989 TFLOP/s. A block owns a 64-row tile of its output and loops
over the other sequence inside the block, with bf16 tensor-core products
(f32 FMA for f32 inputs) and f32 sums; the source's header says what the
simple design leaves on the table.

Each wrapper launches its kernel for CUDA tensors and counts the launch;
for CPU tensors, and only for them, it runs its plain PyTorch version,
which repeats the kernel's arithmetic (products in the input type summed
in f32, ``p`` and ``ds`` rounded to the input type before their second
product). ``flash_attention`` is the differentiable form, mirroring the
JAX package's ``custom_vjp``: the forward saves ``(q, k, v, out, m, l)``
and the backward launches the two backward kernels.
"""

import torch

from adell_mri_torch.ops.kernels.build import load_library
from adell_mri_torch.ops.kernels.conv import _on_card

HEAD_DIMS = (32, 64)
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


# -- plain versions -----------------------------------------------------------


def attention_reference(q, k, v, scale=None):
    """Plain softmax attention with the N x N matrix materialised: f32
    scores and softmax, the output in q's type."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def flash_attention_fwd_reference(q, k, v, scale):
    """Plain version of the forward kernel: ``(out, m, l)`` with m the row
    maximum of the scaled scores and l the row sum of ``exp(s - m)``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / l.clamp_min(1e-30)).to(q.dtype), m, l


def _recompute(q, k, v, dout, lse, delta, scale):
    """p and ds of the backward kernels, from the forward's row
    statistics."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta) * scale


def flash_attention_bwd_dq_reference(q, k, v, dout, lse, delta, scale):
    _, ds = _recompute(q, k, v, dout, lse, delta, scale)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, dout, lse, delta, scale):
    p, ds = _recompute(q, k, v, dout, lse, delta, scale)
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2),
                      dout.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# -- wrappers -----------------------------------------------------------------


def _check(name, q, k, v, rows=(), dout=None):
    """Shapes, types, devices and layout the kernels take. ``rows``: f32
    ``[B, H, Nq, 1]`` statistics; ``dout``: shaped and typed like q."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(
            f"{name}: q and k must be [B, H, N, D], got {tuple(q.shape)} "
            f"and {tuple(k.shape)}"
        )
    b, h, nq, d = q.shape
    if tuple(k.shape[:2]) != (b, h) or k.shape[3] != d or k.shape[2] == 0:
        raise ValueError(
            f"{name}: k {tuple(k.shape)} does not fit q {tuple(q.shape)}"
        )
    if v.shape != k.shape:
        raise ValueError(
            f"{name}: v {tuple(v.shape)} must be shaped like k "
            f"{tuple(k.shape)}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(
            f"{name} takes head dims {HEAD_DIMS}, got {d}"
        )
    if q.dtype not in _SUFFIX:
        raise TypeError(f"{name} takes bf16 or f32, got {q.dtype}")
    if b * h > 65535:
        raise ValueError(f"{name} takes B * H <= 65535, got {b * h}")
    tensors = [("q", q, q.dtype), ("k", k, q.dtype), ("v", v, q.dtype)]
    if dout is not None:
        if dout.shape != q.shape:
            raise ValueError(
                f"{name}: dout {tuple(dout.shape)} must be shaped like q"
            )
        tensors.append(("dout", dout, q.dtype))
    for i, r in enumerate(rows):
        if tuple(r.shape) != (b, h, nq, 1):
            raise ValueError(
                f"{name}: row statistics must be {(b, h, nq, 1)}, got "
                f"{tuple(r.shape)}"
            )
        tensors.append((f"rows[{i}]", r, torch.float32))
    for label, t, dtype in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} is {t.dtype}, want {dtype}")
        if t.device != q.device:
            raise ValueError(f"{name}: {label} is on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")


def _launch(stem, q, tensors, n_kv, scale):
    """Calls ``adell_flash_{stem}_{dtype}`` on q's stream; False when there
    is nothing to compute."""
    b, h, nq, d = q.shape
    if b * h * nq == 0:
        return False
    fn = getattr(load_library(), f"adell_flash_{stem}_{_SUFFIX[q.dtype]}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in tensors), b * h, nq, n_kv, d,
                float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention {stem} launch failed: "
                           f"cudaError {rc}")
    return True


def flash_attention_fwd(q, k, v, scale=None):
    """``(out, m, l)``: out in q's type, m and l f32 ``[B, H, Nq, 1]``.
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not _on_card(q, "flash_attention_fwd"):
        return flash_attention_fwd_reference(q, k, v, scale)
    _check("flash_attention_fwd", q, k, v)
    out = torch.empty_like(q)
    m = torch.empty(q.shape[:3] + (1,), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    flash_attention_fwd.launches += _launch(
        "fwd", q, (q, k, v, out, m, l), k.shape[2], scale
    )
    return out, m, l


#: forward launches since the last reset (set to 0 to start a count)
flash_attention_fwd.launches = 0


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale):
    """dQ from the forward's logsumexp rows ``lse = m + log(l)`` and
    ``delta = rowsum(dout * out)``, both f32 ``[B, H, Nq, 1]``."""
    if not _on_card(q, "flash_attention_bwd_dq"):
        return flash_attention_bwd_dq_reference(
            q, k, v, dout, lse, delta, scale
        )
    _check("flash_attention_bwd_dq", q, k, v, (lse, delta), dout)
    dq = torch.empty_like(q)
    flash_attention_bwd_dq.launches += _launch(
        "bwd_dq", q, (q, k, v, dout, lse, delta, dq), k.shape[2], scale
    )
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale):
    """``(dk, dv)`` from the same inputs as ``flash_attention_bwd_dq``."""
    if not _on_card(q, "flash_attention_bwd_dkv"):
        return flash_attention_bwd_dkv_reference(
            q, k, v, dout, lse, delta, scale
        )
    _check("flash_attention_bwd_dkv", q, k, v, (lse, delta), dout)
    # without query rows no block runs, and the sums over them are 0
    alloc = torch.empty_like if q.shape[2] else torch.zeros_like
    dk, dv = alloc(k), alloc(v)
    flash_attention_bwd_dkv.launches += _launch(
        "bwd_dkv", q, (q, k, v, dout, lse, delta, dk, dv), k.shape[2], scale
    )
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def backward_rows(out, m, l, dout):
    """The two forward residues of the backward kernels, f32
    ``[B, H, Nq, 1]``: the logsumexp rows and ``rowsum(dout * out)``."""
    lse = m + torch.log(l.clamp_min(1e-30))
    delta = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
    return lse, delta


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, m, l = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, m, l = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        lse, delta = backward_rows(out, m, l, g)
        dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, ctx.scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale=None):
    """Softmax attention without the N x N matrix in device memory, with a
    gradient. q ``[B, H, Nq, D]``, k and v ``[B, H, Nkv, D]``, contiguous,
    one type (bf16 or f32), D in ``HEAD_DIMS``; ``scale`` defaults to
    ``D ** -0.5``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v)
    )
    if not needs_grad:
        return flash_attention_fwd(q, k, v, scale)[0]
    return _FlashAttention.apply(q, k, v, scale)
