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
17.4 us at 989 TFLOP/s. A warpgroup owns a 64-row tile of its output
and loops over the other sequence inside the block. In bf16 all three are
Hopper kernels: warpgroup ``wgmma`` products whose sums, scores, p and ds
stay in registers (dK/dV on transposed tiles, so it reduces nothing; dQ,
which reduces nothing either, runs ds k of one tile while p and ds of the
next are taken), fed by a ``cp.async`` ring of swizzled shared-memory
tiles with one block barrier a tile. In f32, the CLI's default precision,
all three are 3xTF32 ``wgmma`` kernels: each f32 product is three TF32
products of operands split into big and small halves, and a preparation
kernel writes, per streamed tile of 32 rows, the image of a ring stage
(the tile's operands split, transposed where a product contracts over the
sequence, swizzled; ``flash_tf32x3_image_reference`` is its plain
version) into a workspace the wrapper allocates. The forward keeps its
online softmax in registers and adds each tile's p v, a fresh tensor-core
sum, to rescaled f32 register sums. ``launch_plan`` mirrors the launchers'
grids, shared-memory sizes and images; the source's header says what
bounds each design.

Each wrapper launches its kernel for CUDA tensors and counts the launch;
for CPU tensors, and only for them, it runs its plain PyTorch version,
which repeats the kernel's arithmetic (products in the input type summed
in f32, ``p`` and ``ds`` rounded to the input type before their second
product). ``flash_attention`` is the differentiable form, mirroring the
JAX package's ``custom_vjp``: the forward saves ``(q, k, v, out, m, l)``
and the backward launches the two backward kernels. It takes any head dim
up to 64, as the JAX function takes any: q, k and v are zero-padded to the
next of ``HEAD_DIMS`` (the scale stays the unpadded D's) and the output
and gradients sliced back.

The forward is also the op ``torch.ops.adell.flash_attention_fwd``
(``torch.library.custom_op``; its implementation is
``flash_attention_fwd``, its fake gives the three outputs' shapes and
types), which ``torch.export`` records by name; ``flash_attention`` calls
through it wherever no gradient is asked for.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

from adell_mri_torch.ops.kernels.build import load_library
from adell_mri_torch.ops.kernels.conv import _on_card, tf32_round

HEAD_DIMS = (32, 64)
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_KINDS = ("fwd", "bwd_dq", "bwd_dkv")
#: most dynamic shared memory a block may ask for on the H100
MAX_SMEM = 232448
#: rows of a streamed tile of the f32 (3xTF32) backward
TF32X3_TILE = 32


def launch_plan(stem, dtype, bh, n_q, n_kv, d):
    """What the C launcher of ``adell_flash_{stem}`` does with a shape:
    ``grid`` (blocks along the sequence the kernel owns, B * H), ``rows``
    of it a block owns, ``threads`` a block, dynamic shared-memory
    ``smem`` bytes, ``tile`` rows of the other sequence a turn streams and
    ``image`` bytes of a streamed tile's prepared image (0 where the kernel
    takes none: bf16). It repeats the layouts of
    ``csrc/flash_attention.cu`` (``FwdPlan``, ``DqPlan``, ``DkvPlan``,
    ``tf32x3::Plan``), whose ``adell_flash_plan_*`` the card tests hold it
    to. The owned rows are query rows for ``fwd`` and
    ``bwd_dq``, key rows for ``bwd_dkv``."""
    if stem not in _KINDS:
        raise ValueError(f"launch_plan: stem must be one of {_KINDS}")
    if d not in HEAD_DIMS or dtype not in _SUFFIX:
        raise ValueError(f"launch_plan: no kernel for D={d}, {dtype}")
    rows, threads, tile, image = 64, 128, 64, 0
    if dtype == torch.bfloat16:
        # wgmma kernels: 64-row swizzled bf16 tiles, 1024 bytes of slack to
        # align them; forward and dQ: a ring of 3 (K, V) stages (Q, and dQ's
        # dO, are in registers); dK/dV: its K and V tiles, a ring of 4
        # (Q, dO) stages and 4 x (lse, delta) rows of 64 f32
        tile_b = 64 * d * 2
        smem = {
            "fwd": 3 * 2 * tile_b,
            "bwd_dq": 3 * 2 * tile_b,
            "bwd_dkv": 2 * tile_b + 4 * (2 * tile_b + 2 * 64 * 4),
        }[stem] + 1024
    else:
        # 3xTF32: two warpgroups of 64 rows; a ring of images of 32-row
        # tiles (3 for the forward: K, V^T; 3 for dQ: K, V, K^T; 2 for
        # dK/dV: Q, dO, Q^T, dO^T and 1024 bytes for lse and delta), each
        # panel 128 d bytes big and as many small; the block's raw A
        # operands (the forward's Q; dQ's Q and dO; dK/dV's K and V), rows
        # of d + 4 f32; 1024 bytes of slack to align the ring
        rows, threads, tile = 128, 256, TF32X3_TILE
        panel = 128 * d
        image, stages, operands = {"fwd": (4 * panel, 3, 1),
                                   "bwd_dq": (6 * panel, 3, 2),
                                   "bwd_dkv": (8 * panel + 1024, 2, 2)}[stem]
        smem = stages * image + operands * rows * (d + 4) * 4 + 1024
    owned = n_kv if stem == "bwd_dkv" else n_q
    return dict(grid=(-(-owned // rows), bh), rows=rows, threads=threads,
                smem=smem, tile=tile, image=image)


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


#: the image's order of the rows of each group of 8 in a transposed panel:
#: position p holds row 2p (p < 4) or 2 (p - 4) + 1, so that the f32 sums a
#: thread holds (columns 2t, 2t + 1) are TF32 A fragments (k = t, t + 4)
_PERM8 = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])


def _swizzled(x):
    """``[..., R, 32]`` f32 rows of 128 bytes, as a 128-byte-swizzled tile
    stores them: chunk c (4 f32) of row r at chunk c ^ (r % 8), flattened
    to ``[..., R * 32]``."""
    r = x.shape[-2]
    rows = torch.arange(r, device=x.device)[:, None]
    chunks = x.reshape(*x.shape[:-1], 8, 4)
    # the slot and the chunk it holds are each other's XOR with r % 8
    held = torch.arange(8, device=x.device)[None, :] ^ (rows % 8)
    return chunks[..., rows, held, :].reshape(*x.shape[:-2], r * 32)


def flash_tf32x3_image_reference(kind, a, b, lse=None, delta=None):
    """Plain version of ``flash_tf32x3_image_kernel``, which prepares the
    B operands of the 3xTF32 kernels: ``a``, ``b`` f32 ``[B, H, n, D]``
    (kind 0, dQ: K and V; kind 1, dK/dV: Q and dO, with ``lse`` and
    ``delta`` f32 ``[B, H, n, 1]``; kind 2, forward: K and V). Returns
    ``[B * H, tiles, floats]``: for each tile of 32 rows (rows past n zero)
    the panels a, b, a^T (and b^T for kind 1; a and b^T for kind 2), each
    its big half ``tf32(x)`` then its small half
    ``tf32(x - big)``; a natural panel is D / 32 sub-tiles of 32 rows by
    32 columns, a transposed one D rows by the 32 tile rows, permuted
    inside each group of 8 by ``_PERM8``; every sub-tile 128-byte
    swizzled. Kind 1 ends with the tile's 32 lse, 32 delta and 192
    zeros."""
    bsz, h, n, d = a.shape
    tile = TF32X3_TILE
    tiles = -(-n // tile)

    def tiled(x):
        x = F.pad(x.reshape(bsz * h, n, x.shape[-1]),
                  (0, 0, 0, tiles * tile - n))
        return x.reshape(bsz * h, tiles, tile, x.shape[-1])

    def natural(x):
        x = x.reshape(*x.shape[:3], d // 32, 32).transpose(2, 3)
        return _swizzled(x).flatten(2)

    def transposed(x):
        pos = torch.arange(tile, device=x.device)
        perm = pos // 8 * 8 + _PERM8.to(x.device)[pos % 8]
        return _swizzled(x[:, :, perm].transpose(2, 3))

    xa, xb = tiled(a.float()), tiled(b.float())
    if kind == 2:
        panels = [natural(xa), transposed(xb)]
    else:
        panels = [natural(xa), natural(xb), transposed(xa)]
    if kind == 1:
        panels.append(transposed(xb))
    parts = []
    for panel in panels:
        big = tf32_round(panel)
        parts += [big, tf32_round(panel - big)]
    if kind == 1:
        rows = torch.cat([tiled(lse.float()), tiled(delta.float())], dim=2)
        parts.append(F.pad(rows.flatten(2), (0, 256 - 2 * tile)))
    return torch.cat(parts, dim=2)


# -- wrappers -----------------------------------------------------------------


def _check(name, q, k, v, rows=(), dout=None, scale=None):
    """Shapes, types, devices, layout and scale the kernels take. ``rows``:
    f32 ``[B, H, Nq, 1]`` statistics; ``dout``: shaped and typed like q."""
    if scale is not None and not 0.0 < float(scale) < float("inf"):
        # the Hopper kernels take the row maximum before they scale
        raise ValueError(f"{name} takes a positive finite scale, got {scale}")
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
    if max(nq, k.shape[2]) > 2**31 - 128:
        raise ValueError(f"{name}: sequence too long for 32-bit tile indices")
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
    plan = launch_plan(stem, q.dtype, b * h, nq, n_kv, d)
    if plan["smem"] > MAX_SMEM:
        raise ValueError(f"flash_attention {stem}: {plan['smem']} bytes of "
                         f"shared memory a block, the card gives {MAX_SMEM}")
    # the workspace: the f32 kernels' images of the streamed tiles, written
    # by their preparation kernel (none in bf16)
    tiles = -(-(nq if stem == "bwd_dkv" else n_kv) // plan["tile"])
    tensors = (*tensors, torch.empty(
        b * h * tiles * plan["image"] // 4, dtype=torch.float32,
        device=q.device) if plan["image"] else None)
    fn = getattr(load_library(), f"adell_flash_{stem}_{_SUFFIX[q.dtype]}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*(None if t is None else t.data_ptr() for t in tensors),
                b * h, nq, n_kv, d, float(scale), stream)
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
    _check("flash_attention_fwd", q, k, v, scale=scale)
    out = torch.empty_like(q)
    m = torch.empty(q.shape[:3] + (1,), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    flash_attention_fwd.launches += _launch(
        "fwd", q, (q, k, v, out, m, l), k.shape[2], scale
    )
    return out, m, l


#: forward launches since the last reset (set to 0 to start a count)
flash_attention_fwd.launches = 0


@torch.library.custom_op("adell::flash_attention_fwd", mutates_args=())
def flash_attention_fwd_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``flash_attention_fwd`` as an op that ``torch.export`` records."""
    return flash_attention_fwd(q, k, v, scale)


@flash_attention_fwd_op.register_fake
def _(q, k, v, scale):
    rows = q.new_empty(q.shape[:3] + (1,), dtype=torch.float32)
    return torch.empty_like(q), rows, torch.empty_like(rows)


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale):
    """dQ from the forward's logsumexp rows ``lse = m + log(l)`` and
    ``delta = rowsum(dout * out)``, both f32 ``[B, H, Nq, 1]``."""
    if not _on_card(q, "flash_attention_bwd_dq"):
        return flash_attention_bwd_dq_reference(
            q, k, v, dout, lse, delta, scale
        )
    _check("flash_attention_bwd_dq", q, k, v, (lse, delta), dout, scale)
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
    _check("flash_attention_bwd_dkv", q, k, v, (lse, delta), dout, scale)
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


def padded_head_dim(d):
    """The kernels' head dim that serves a head dim of ``d``: the least of
    ``HEAD_DIMS`` not below it; None above them."""
    return next((h for h in HEAD_DIMS if d <= h), None)


def _pad_head(x, dp):
    """``x`` zero-padded along its last axis to ``dp``: zero columns of q,
    k and v change neither q k^T nor the kept columns of the output."""
    return x if x.shape[-1] == dp else F.pad(x, (0, dp - x.shape[-1]))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, dp):
        d = q.shape[-1]
        q, k, v = (_pad_head(t, dp) for t in (q, k, v))
        out, m, l = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.scale, ctx.d = scale, d
        return out if dp == d else out[..., :d].contiguous()

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, m, l = ctx.saved_tensors
        d = ctx.d
        g = _pad_head(g.to(q.dtype), q.shape[-1]).contiguous()
        lse, delta = backward_rows(out, m, l, g)
        dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, ctx.scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, ctx.scale)
        return dq[..., :d], dk[..., :d], dv[..., :d], None, None


def flash_attention(q, k, v, scale=None):
    """Softmax attention without the N x N matrix in device memory, with a
    gradient. q ``[B, H, Nq, D]``, k and v ``[B, H, Nkv, D]``, contiguous,
    one type (bf16 or f32); ``scale`` defaults to ``D ** -0.5``. A head
    dim below one of ``HEAD_DIMS`` runs the kernels on q, k and v
    zero-padded to it (with the unpadded D's scale), and the output and
    gradients are sliced back; a head dim above them raises on CUDA
    tensors (there is no kernel variant for it) and takes the plain
    version on CPU tensors. Without a gradient, the forward alone through
    the op ``adell::flash_attention_fwd``."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    dp = padded_head_dim(d)
    if dp is None:
        if q.device.type == "cuda":
            raise NotImplementedError(
                f"flash_attention has kernels for head dims up to "
                f"{HEAD_DIMS[-1]}, got {d} (a D = 128 variant is ROADMAP "
                "Queue 2 work)"
            )
        dp = d
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v)
    )
    if not needs_grad:
        out = flash_attention_fwd_op(
            *(_pad_head(t, dp) for t in (q, k, v)), float(scale))[0]
        return out if dp == d else out[..., :d]
    return _FlashAttention.apply(q, k, v, scale, dp)
