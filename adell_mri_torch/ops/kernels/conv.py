"""
3x3x3 stride-1 SAME 3D convolution forward on hand-written Hopper kernels.

Counterpart of ``adell_mri_tpu/ops/pallas/conv.py``: the CUDA kernels in
``adell_mri_torch/csrc/conv3d_igemm.cu`` and ``csrc/conv3d_tf32.cu``
replace that module's ``_kernel`` (the TPU implicit-GEMM conv). Both are
implicit GEMMs over M = B*D*H*W voxels, N = Cout and K = 27*Cin whose
patch matrix never reaches device memory, with f32 sums and the bias fused
into the epilogue. Four routes, chosen by ``conv_route``:

- ``"narrow"`` (bf16 or f32, one side of at most 4 channels and the other
  of at most 64: the Cin=1 stems, the Cout=1 input gradient, multi-sequence
  stems such as 3->32): bound by bytes, so a block loads its box's input
  halo into shared memory once per vector of channels and sums the 27
  taps with f32 FMA from there, the weight resident beside it;
- ``"wgmma"`` (bf16, Cin a multiple of 16, Cout of 8: every other bf16
  conv of the main paths): a block owns a box of output voxels
  (``plan_box``, within the launcher's limits: ``wgmma_box``), loads its
  input halo into shared memory once per channel chunk and runs the 27
  taps from there as ``wgmma`` products with A from registers (``ldmatrix``
  at each row's shifted address) and the weight streamed through a
  ``cp.async`` ring;
- ``"tf32"`` (f32, Cin and Cout multiples of 8: every other f32 conv of the
  main paths, which run in f32 unless ``--precision bf16`` is given): the
  same box, halo and ring in ``csrc/conv3d_tf32.cu``, each f32 product
  taken as three TF32 tensor-core products (3xTF32: big and small TF32
  parts of both operands, ``small*big + big*small + big*big``), which keeps
  f32's accuracy; the wrapper prepares the weight once a call, or once a
  ``same_conv_weights`` block (``tf32_split_weight``: K-major, split and
  rounded as ``cvt.rna.tf32`` rounds, ``tf32_round``) and takes the box
  from ``plan_box`` within the launcher's limits (``tf32_limits``);
- ``"igemm"`` (the rest: bf16 widths between the narrow and wgmma routes,
  f32 widths that are not multiples of 8): the first kernel, which gathers
  a patch tile per k-step (WMMA in bf16, FMA in f32).

The sources' headers say what bounds each on the H100 and what its design
does about that. ``conv3d_igemm`` launches a kernel for CUDA tensors and
runs the plain version, ``conv3d_igemm_reference``, only for CPU tensors.
Unlike the TPU kernel it has no shape gate: every Cin/Cout and spatial size
is taken. Its ``launches`` counts every launch, ``wgmma_launches``,
``tf32_launches`` and ``narrow_launches`` those of the three Hopper routes
(``conv3d_igemm_dx`` likewise).

``conv3d_igemm_train`` is the differentiable form, mirroring
``_conv3d_im2col_bwd`` in ``adell_mri_tpu/ops/conv.py`` for stride 1 and
SAME: dx is the same kernel (``conv3d_igemm_dx``) on the cotangent with
the spatially flipped, channel-swapped weight; dW is ``conv3d_weight_grad``;
dbias is the cotangent's sum. On CPU tensors forward and backward both take
the plain version.

dW (``conv3d_weight_grad``) has two routes, chosen by ``wgrad_route``:

- ``"wgmma"`` (bf16, Cin a multiple of 16, Cout of 8, Cout <= 256: the
  classes of the forward's wgmma route): the hand-written kernel of
  ``csrc/conv3d_wgrad.cu``, the forward's box and halo with the GEMM turned
  around (rows (tap, ci) of dW, columns Cout, the box's voxels the
  contraction). As for the forward, ``plan_box`` picks the box within the
  limits the launcher gives (``wgmma_box`` with
  ``adell_conv3d_wgrad_limits``); the launcher owns the rest of the
  decomposition: a block takes T 64-row tiles of one channel chunk and an
  N block and walks a range of boxes; the voxels are split S ways into f32
  partials in a workspace that a second kernel sums in a fixed order and
  rounds once (no atomics). ``adell_conv3d_wgrad_plan`` reports it,
  ``wgrad_plan`` mirrors it for the CPU tests. The patch tensor never
  exists;
- ``"patches"`` (the rest: Cin < 16, as at the stems, whose patch tensor is
  27 single channels, and f32): the padded input's patch tensor ``[V, 27
  Cin]`` times the cotangent in one product with f32 sums, the JAX
  package's own formulation outside Pallas. It is also the plain version
  (``conv3d_weight_grad_reference``), the kernel's oracle.

Its counters are ``launches`` (the kernel) and ``patch_calls`` (CUDA calls
of the patch route); CPU tensors count neither.

The forward is also the op ``torch.ops.adell.conv3d_igemm`` (a
``torch.library.custom_op`` whose implementation is ``conv3d_igemm``, so
a CUDA tensor launches the routed kernel and a CPU tensor takes the plain
version, and whose fake gives the output's shape and type), which
``torch.export`` records by name where a ``ctypes`` launch on a data
pointer cannot be traced. ``conv3d_igemm_train`` calls through the op
wherever no gradient is asked for, so a trace under ``no_grad`` (the
exporter's, ``train/export.py``) records it and the live paths launch
and count as the op's implementation does.
"""

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from adell_mri_torch.ops.kernels.build import load_library

_LAUNCHERS = {
    torch.bfloat16: "adell_conv3d_igemm_bf16",
    torch.float32: "adell_conv3d_igemm_f32",
}


_NARROW_LAUNCHERS = {
    torch.bfloat16: "adell_conv3d_narrow_bf16",
    torch.float32: "adell_conv3d_narrow_f32",
}
#: the narrow route's widths: one side at most NARROW, the other MAX_NARROW
NARROW, MAX_NARROW = 4, 64


def conv_route(dtype, cin, cout):
    """The kernel a CUDA call takes: ``"narrow"`` when one side has at most
    4 channels and the other at most 64 (either dtype); else ``"wgmma"``
    for bf16 with Cin a multiple of 16 and Cout a multiple of 8, and
    ``"tf32"`` for f32 with Cin and Cout multiples of 8; else ``"igemm"``.
    Narrow and the two Hopper routes are disjoint: a side of at most 4
    channels is no multiple of 8."""
    if min(cin, cout) <= NARROW and max(cin, cout) <= MAX_NARROW:
        return "narrow"
    if dtype == torch.bfloat16 and cin % 16 == 0 and cout % 8 == 0:
        return "wgmma"
    if dtype == torch.float32 and cin % 8 == 0 and cout % 8 == 0:
        return "tf32"
    return "igemm"


@functools.lru_cache(maxsize=None)
def plan_box(d, h, w, voxels, max_halo_rows=None):
    """The box ``(tz, ty, tx)`` of ``voxels`` output voxels (powers of two)
    a block owns: fewest boxes over the volume first (ragged boxes compute
    voxels that are not stored), then the smallest halo ``(tz + 2) (ty + 2)
    (tx + 2)``, then the widest x, whose rows lie side by side in memory.
    Boxes whose halo has more than ``max_halo_rows`` rows are left out."""
    best = None
    n = voxels.bit_length() - 1
    if 1 << n != voxels:
        raise ValueError(f"plan_box: {voxels} voxels is not a power of two")
    for ez in range(n + 1):
        for ey in range(n + 1 - ez):
            tz, ty, tx = 1 << ez, 1 << ey, 1 << (n - ez - ey)
            halo = (tz + 2) * (ty + 2) * (tx + 2)
            if max_halo_rows is not None and halo > max_halo_rows:
                continue
            boxes = -(-d // tz) * -(-h // ty) * -(-w // tx)
            key = (boxes, halo, -tx, -ty)
            if best is None or key < best[0]:
                best = (key, (tz, ty, tx))
    if best is None:
        raise ValueError(f"plan_box: no box of {voxels} voxels has a halo "
                         f"of at most {max_halo_rows} rows")
    return best[1]


@functools.lru_cache(maxsize=None)
def wgmma_box(lib, d, h, w, cin, cout, limits="adell_conv3d_wgmma_limits"):
    """The box of a ``"wgmma"`` launch over a ``d x h x w`` volume: the
    launcher owns the kernel's shared-memory layout and gives the box's
    voxel count and the most halo rows that fit beside its weight ring
    (``limits``: ``adell_conv3d_wgmma_limits``, or the wgrad kernel's
    ``adell_conv3d_wgrad_limits``, beside its cotangent tiles);
    ``plan_box`` picks from those. Cached, so a launch pays for it once a
    shape."""
    got = (ctypes.c_int * 2)()
    rc = getattr(lib, limits)(cin, cout, got)
    if rc != 0:
        raise ValueError(f"wgmma_box: no kernel for {cin}->{cout}")
    return plan_box(d, h, w, got[0], got[1])


class Tf32Plan(NamedTuple):
    """The 3xTF32 kernel's layout for Cin -> Cout (``Plan`` in
    ``csrc/conv3d_tf32.cu``)."""

    ck: int             # channels of a chunk (its halo)
    nb: int             # N block
    cout_pad: int       # rows of the prepared weight: Cout in whole N blocks
    g: int              # taps a ring stage
    stages: int         # ring stages
    voxels: int         # output voxels of a box
    max_halo_rows: int  # the most halo rows that fit beside the ring


def tf32_plan(cin, cout):
    """``Plan`` of ``csrc/conv3d_tf32.cu``, worked out in Python (the card
    tests hold ``adell_conv3d_wgmma_tf32x3_limits`` to it): a box of 128
    voxels, a chunk of the largest of 32, 16, 8 channels dividing Cin (halo
    rows of 4 ck + 16 bytes), an N block of Cout padded to 16, 32 or 64 (a
    wider Cout in several), G taps a stage (the fewest of 1, 3, 9 whose
    products G * ck * nb reach 512), a tap's big and small slabs of nb rows
    of ck f32, four stages each rounded to 1024 bytes, 1024 bytes of
    alignment, and two halo buffers when Cin has several chunks."""
    if conv_route(torch.float32, cin, cout) != "tf32":
        raise ValueError(f"tf32: no kernel for {cin}->{cout}")
    smem = 232448  # the shared memory a block may have
    ck = next(c for c in (32, 16, 8) if cin % c == 0)
    nb = next(n for n in (16, 32, 64) if n >= min(cout, 64))
    row, tap = 4 * ck + 16, 2 * nb * ck * 4
    g = next((g for g in (1, 3) if g * ck * nb >= 512), 9)
    stages = 4
    ring = stages * (-(-g * tap // 1024) * 1024)
    bufs = 2 if cin > ck else 1
    room = (smem - ring - 1024) // bufs // 128 * 128
    return Tf32Plan(ck, nb, -(-cout // nb) * nb, g, stages, 128,
                    room // row)


@functools.lru_cache(maxsize=None)
def tf32_limits(lib, cin, cout):
    """What ``adell_conv3d_wgmma_tf32x3_limits`` gives for Cin -> Cout: the
    output voxels of a box, the most halo rows that fit beside the weight
    ring, and Cout_pad, the rows of the prepared weight. Cached, so a
    launch pays for it once a class."""
    got = (ctypes.c_int * 3)()
    rc = lib.adell_conv3d_wgmma_tf32x3_limits(cin, cout, got)
    if rc != 0:
        raise ValueError(f"tf32: no kernel for {cin}->{cout}")
    return tuple(got)


def tf32_round(t):
    """``cvt.rna.tf32.f32`` on an f32 tensor: each value rounded to TF32's
    10-bit mantissa, to nearest with ties away from zero (adding half a
    TF32 ulp to the magnitude's bits, a carry into the exponent included),
    in f32's format with the low 13 bits zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split_weight(w, cout_pad):
    """The 3xTF32 kernel's weight: ``w`` [3,3,3,Cin,Cout] f32 as [2, 27,
    cout_pad, Cin], K-major (a tap's rows are its output channels, each Cin
    long, as TF32 ``wgmma`` reads B), big = tf32(w) first, then small =
    tf32(w - big); rows past Cout are zero. big + small is w within 2^-22
    of its magnitude."""
    cin, cout = w.shape[3], w.shape[4]
    wk = F.pad(w.reshape(27, cin, cout).transpose(1, 2),
               (0, 0, 0, cout_pad - cout))
    big = tf32_round(wk)
    return torch.stack((big, tf32_round(wk - big)))


#: the 3xTF32 route's prepared weights while a ``same_conv_weights`` block
#: is open, by the id of the weight (held, so that the id stays its own);
#: None outside such a block
_tf32_weights = None


@contextlib.contextmanager
def same_conv_weights():
    """Within this block no conv weight changes, so the 3xTF32 route
    prepares each weight once (``tf32_split_weight``) instead of once a
    launch: a served case launches each of the flagship U-Net's 29 such
    convs once a window batch. The sliding window opens it around its
    micro-batches; a block opened inside another shares the outer one's
    weights. Nothing is kept after the outermost block."""
    global _tf32_weights
    if _tf32_weights is not None:
        yield
        return
    _tf32_weights = {}
    try:
        yield
    finally:
        _tf32_weights = None


def _tf32_weight(w, cout_pad):
    """``tf32_split_weight(w, cout_pad)``, made once a ``same_conv_weights``
    block (cout_pad follows from w's shape)."""
    if _tf32_weights is None:
        return tf32_split_weight(w, cout_pad)
    hit = _tf32_weights.get(id(w))
    if hit is None:
        hit = _tf32_weights[id(w)] = (w, tf32_split_weight(w, cout_pad))
    return hit[1]


def conv3d_igemm_reference(x, w, bias=None):
    """Plain PyTorch version: x [B,D,H,W,Cin], w [3,3,3,Cin,Cout], stride 1,
    SAME; f32 accumulation, output in the input dtype."""
    y = F.conv3d(
        x.float().permute(0, 4, 1, 2, 3),
        w.float().permute(4, 3, 0, 1, 2),
        None if bias is None else bias.float(),
        padding=1,
    )
    return y.permute(0, 2, 3, 4, 1).to(x.dtype).contiguous()


def _check_shapes(x, w, bias):
    if x.dim() != 5:
        raise ValueError(f"x must be [B,D,H,W,Cin], got {tuple(x.shape)}")
    cin = x.shape[-1]
    if w.dim() != 5 or tuple(w.shape[:4]) != (3, 3, 3, cin):
        raise ValueError(
            f"w must be [3,3,3,{cin},Cout] for x {tuple(x.shape)}, got "
            f"{tuple(w.shape)}"
        )
    if bias is not None and tuple(bias.shape) != (w.shape[-1],):
        raise ValueError(
            f"bias must be [{w.shape[-1]}], got {tuple(bias.shape)}"
        )


def _check(x, w, bias):
    _check_shapes(x, w, bias)
    if x.dtype not in _LAUNCHERS:
        raise TypeError(f"conv3d_igemm takes bf16 or f32, got {x.dtype}")
    tensors = [("x", x), ("w", w)]
    if bias is not None:
        tensors.append(("bias", bias))
    for name, t in tensors:
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    voxels = x.shape[:4].numel()
    if voxels * max(x.shape[-1], w.shape[-1]) >= 2**31:
        raise ValueError("conv3d_igemm takes tensors below 2**31 elements")


def _launch(x, w, bias):
    """Launches the routed kernel; returns the output and the route (None
    when there was nothing to compute)."""
    _check(x, w, bias)
    b, d, h, w_sz, cin = x.shape
    cout = w.shape[-1]
    out = torch.empty((b, d, h, w_sz, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out, None
    lib = load_library()
    route = conv_route(x.dtype, cin, cout)
    ptrs = (x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "wgmma":
            box = wgmma_box(lib, d, h, w_sz, cin, cout)
            rc = lib.adell_conv3d_wgmma_bf16(
                *ptrs, b, d, h, w_sz, cin, cout, *box, stream)
        elif route == "tf32":
            voxels, rows, cout_pad = tf32_limits(lib, cin, cout)
            box = plan_box(d, h, w_sz, voxels, rows)
            wk = _tf32_weight(w, cout_pad)
            rc = lib.adell_conv3d_wgmma_tf32x3(
                ptrs[0], wk.data_ptr(), *ptrs[2:], b, d, h, w_sz, cin, cout,
                *box, stream)
        elif route == "narrow":
            rc = getattr(lib, _NARROW_LAUNCHERS[x.dtype])(
                *ptrs, b, d, h, w_sz, cin, cout, stream)
        else:
            rc = getattr(lib, _LAUNCHERS[x.dtype])(
                *ptrs, b, d, h, w_sz, cin, cout, stream)
    if rc != 0:
        raise RuntimeError(
            f"conv3d_igemm ({route}) launch failed: cudaError {rc}")
    return out, route


def _count(fn, route):
    fn.launches += route is not None
    fn.wgmma_launches += route == "wgmma"
    fn.tf32_launches += route == "tf32"
    fn.narrow_launches += route == "narrow"


def _on_card(x, name):
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return True


def conv3d_igemm(x, w, bias=None):
    """x [B,D,H,W,Cin], w [3,3,3,Cin,Cout], bias [Cout] or None, one dtype
    (bf16 or f32). Stride-1 SAME conv with f32 accumulation, returned in
    the input dtype. CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if not _on_card(x, "conv3d_igemm"):
        return conv3d_igemm_reference(x, w, bias)
    out, route = _launch(x, w, bias)
    _count(conv3d_igemm, route)
    return out


#: forward launches since the last reset (set to 0 to start a count), and
#: those of them that took the "wgmma", the "tf32" and the "narrow" route
conv3d_igemm.launches = 0
conv3d_igemm.wgmma_launches = 0
conv3d_igemm.tf32_launches = 0
conv3d_igemm.narrow_launches = 0


def conv3d_igemm_dx(g, w):
    """Input gradient of the stride-1 SAME conv: the same kernel on the
    cotangent ``g`` [B,D,H,W,Cout] with ``w`` flipped in space and its
    channel axes swapped (``[3,3,3,Cout,Cin]``). Counted apart from the
    forward launches."""
    w_rot = w.flip(0, 1, 2).transpose(3, 4).contiguous()
    if not _on_card(g, "conv3d_igemm_dx"):
        return conv3d_igemm_reference(g, w_rot)
    dx, route = _launch(g, w_rot, None)
    _count(conv3d_igemm_dx, route)
    return dx


#: backward (dx) launches since the last reset, and the three Hopper
#: routes'
conv3d_igemm_dx.launches = 0
conv3d_igemm_dx.wgmma_launches = 0
conv3d_igemm_dx.tf32_launches = 0
conv3d_igemm_dx.narrow_launches = 0


#: bytes the patch tensor of one product of the patch route may take
PATCH_BUDGET = 2 << 30


def _patch_bytes(dtype) -> int:
    """Bytes a patch element takes in a chunked product: the patch tensor
    itself and, for a dtype narrower than f32, its f32 copy."""
    size = torch.empty((), dtype=dtype).element_size()
    return size + 4 if size < 4 else size


def patch_chunks(shape, dtype, budget=PATCH_BUDGET):
    """The chunks whose patch tensors stay within ``budget`` bytes, for x
    of ``shape`` [B,D,H,W,Cin]: ``(b0, b1, z0, z1)`` takes samples
    ``b0:b1``, planes ``z0:z1`` of each. One chunk (the whole batch) where
    its patch tensor fits; else whole samples, each chunk's patch tensor
    and its f32 copy (``_patch_bytes``) within the budget; where one
    sample alone exceeds it, a chunk is a slab of D-planes of one sample
    (cut from the padded input with its one-plane halo)."""
    b, d, h, w_sz, cin = shape
    size = torch.empty((), dtype=dtype).element_size()
    if b * d * h * w_sz * 27 * cin * size <= budget:
        return [(0, b, 0, d)]
    plane = h * w_sz * 27 * cin * _patch_bytes(dtype)
    if d * plane <= budget:
        n = budget // (d * plane)
        return [(i, min(i + n, b), 0, d) for i in range(0, b, n)]
    p = max(1, budget // plane)
    return [(i, i + 1, z, min(z + p, d))
            for i in range(b) for z in range(0, d, p)]


def _patches(xp, cin):
    """The patch tensor [V, 27*Cin] of a padded input [B,D+2,H+2,W+2,Cin]:
    [B,D,H,W,Cin,3,3,3] -> [B,D,H,W,3,3,3,Cin], so k = tap*Cin + ci, the
    row-major flattening of the weight."""
    return (xp.unfold(1, 3, 1).unfold(2, 3, 1).unfold(3, 3, 1)
            .permute(0, 1, 2, 3, 5, 6, 7, 4).reshape(-1, 27 * cin))


def patch_sums(x, g, chunks):
    """The sums [27*Cin, Cout] of the patch products over ``chunks``
    (``patch_chunks``), in f32 (f64 for f64 inputs): each chunk's product
    summed there, the chunks added in order."""
    cin, cout = x.shape[-1], g.shape[-1]
    acc = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    dw = torch.zeros((27 * cin, cout), dtype=acc, device=x.device)
    for b0, b1, z0, z1 in chunks:
        patches = _patches(xp[b0:b1, z0:z1 + 2], cin)
        # bf16 products are exact in f32 and summed there
        dw += torch.matmul(patches.t().to(acc),
                           g[b0:b1, z0:z1].reshape(-1, cout).to(acc))
    return dw


def conv3d_weight_grad_reference(x, g, budget=PATCH_BUDGET):
    """Plain version of dW [3,3,3,Cin,Cout] of the stride-1 SAME conv: the
    padded input's patch tensor [V, 27*Cin] contracted with ``g`` [V, Cout]
    over the voxels (f32 accumulation rounded once to x's dtype). The
    patch tensor is transient and 27x the input, so the contraction runs
    in chunks whose patch tensors stay within ``budget`` bytes
    (``patch_sums`` over ``patch_chunks``). A bf16 batch whose patch
    tensor fits takes one bf16 product instead (the tensor cores'), which
    sums in f32 inside the library."""
    cin, cout = x.shape[-1], g.shape[-1]
    chunks = patch_chunks(tuple(x.shape), x.dtype, budget)
    if len(chunks) > 1 or x.element_size() >= 4:
        return patch_sums(x, g, chunks).to(x.dtype).reshape(
            3, 3, 3, cin, cout)
    patches = _patches(F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1)), cin)
    # bf16 products summed in f32 and rounded once, as the JAX package's
    # preferred_element_type=f32: cuBLAS may otherwise reduce its split-K
    # partial sums in bf16
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        dw = torch.matmul(patches.t(), g.reshape(-1, cout))
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced
    return dw.reshape(3, 3, 3, cin, cout)


def wgrad_route(dtype, cin, cout):
    """The route of a CUDA dW call: ``"wgmma"`` (the kernel) for bf16 with
    Cin a multiple of 16, Cout a multiple of 8 and Cout <= 256, else
    ``"patches"`` (the patch product). Chosen by the class alone."""
    if (dtype == torch.bfloat16 and cin % 16 == 0 and cout % 8 == 0
            and cout <= 256):
        return "wgmma"
    return "patches"


#: voxels of a wgrad box, and the shipped build of ``csrc/conv3d_wgrad.cu``
#: (its macros' defaults), for the Python mirror of its plan
WGRAD_VOXELS, WGRAD_WARPGROUPS, WGRAD_STAGES = 256, 2, 2
WGRAD_ACC, WGRAD_WAVES, WGRAD_MAX_SMEM = 128, 2, 232448


class WgradPlan(NamedTuple):
    """The wgrad launch's decomposition, in the order
    ``adell_conv3d_wgrad_plan`` reports it."""

    tz: int
    ty: int
    tx: int
    ck: int        # channels of a chunk (its halo)
    nb: int        # N block
    t: int         # 64-row tiles a warpgroup
    nwg: int       # warpgroups a block
    tiles: int     # 64-row tiles of a chunk's 27 * ck rows
    groups: int    # groups of nwg * t tiles a chunk
    n_blocks: int
    splits: int    # S: voxel ranges
    boxes: int     # boxes of the batch
    smem: int      # shared-memory bytes a block

    def split_range(self, s):
        """The boxes ``[start, stop)`` of split ``s``."""
        return s * self.boxes // self.splits, (s + 1) * self.boxes // self.splits


def _wgrad_blocking(cin, cout):
    """The N block (Cout padded to 16, 32 or 64, wider Couts in blocks of
    64); the channel chunk, the widest of 64, 32, 16 dividing Cin whose 27
    * ck rows (64-row tiles shared by two warpgroups) fit 128 accumulator
    registers a thread at N / 2 a tile, else 16; its tiles; T, the tiles a
    warpgroup."""
    if wgrad_route(torch.bfloat16, cin, cout) != "wgmma":
        raise ValueError(f"wgrad: no kernel for {cin}->{cout}")
    nb = next(n for n in (16, 32, 64) if n >= min(cout, 64))

    def chunk_tiles(ck):  # 64-row tiles of a chunk's 27 * ck rows
        return -(-27 * ck // 64)

    def tiles_of(ck):  # a warpgroup's share of them, as registers allow
        share = -(-chunk_tiles(ck) // WGRAD_WARPGROUPS)
        return max(min(WGRAD_ACC // (nb // 2), share), 1)

    ck = next((c for c in (64, 32) if cin % c == 0 and tiles_of(c)
               * WGRAD_WARPGROUPS >= chunk_tiles(c)), 16)
    return nb, ck, chunk_tiles(ck), tiles_of(ck)


def wgrad_limits(cin, cout):
    """``adell_conv3d_wgrad_limits`` for the shipped build, worked out in
    Python: the voxels of a box and the most halo rows of a chunk that fit
    beside the cotangent tile in each of two stages."""
    nb, ck, _, _ = _wgrad_blocking(cin, cout)
    room = ((WGRAD_MAX_SMEM - 1024) // WGRAD_STAGES
            - WGRAD_VOXELS * nb * 2) // 1024 * 1024
    return WGRAD_VOXELS, room // (2 * ck + 16)


def wgrad_plan(b, d, h, w, cin, cout, n_sm=132):
    """The wgrad launch's decomposition (``plan_of`` in
    ``csrc/conv3d_wgrad.cu``) for the shipped build, worked out in Python:
    the box from ``plan_box`` within ``wgrad_limits``; the blocking of
    ``_wgrad_blocking``; S the fewest splits that give two blocks an SM, at
    most one a box."""
    nb, ck, tiles, t = _wgrad_blocking(cin, cout)
    tz, ty, tx = plan_box(d, h, w, *wgrad_limits(cin, cout))
    boxes = b * -(-d // tz) * -(-h // ty) * -(-w // tx)
    groups = -(-tiles // (WGRAD_WARPGROUPS * t))
    n_blocks = -(-cout // nb)
    blocks = cin // ck * groups * n_blocks
    splits = min(max(-(-WGRAD_WAVES * n_sm // blocks), 1), boxes)
    halo = (tz + 2) * (ty + 2) * (tx + 2) * (2 * ck + 16)
    smem = (WGRAD_STAGES * (WGRAD_VOXELS * nb * 2 + -(-halo // 1024) * 1024)
            + 1024)
    return WgradPlan(tz, ty, tx, ck, nb, t, WGRAD_WARPGROUPS, tiles, groups,
                     n_blocks, splits, boxes, smem)


@functools.lru_cache(maxsize=None)
def launcher_wgrad_plan(lib, b, d, h, w, cin, cout, n_sm):
    """The decomposition of a launch: the box from ``wgmma_box`` within the
    launcher's limits, the rest as ``adell_conv3d_wgrad_plan`` reports it
    for that box, cached per shape (the wrapper sizes the workspace from its
    S)."""
    box = wgmma_box(lib, d, h, w, cin, cout, "adell_conv3d_wgrad_limits")
    got = (ctypes.c_int * 13)()
    rc = lib.adell_conv3d_wgrad_plan(b, d, h, w, cin, cout, *box, n_sm, got)
    if rc != 0:
        raise ValueError(f"wgrad: no kernel for {cin}->{cout} at "
                         f"{(b, d, h, w)}")
    return WgradPlan(*got)


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_wgrad(x, g):
    b, d, h, w_sz, cin = x.shape
    cout = g.shape[-1]
    for name, t in (("x", x), ("g", g)):
        if t.dtype != torch.bfloat16 or t.device != x.device:
            raise TypeError(f"wgrad: {name} must be bf16 on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"wgrad: {name} must be contiguous and "
                             "16-byte aligned")
    if tuple(g.shape[:4]) != tuple(x.shape[:4]):
        raise ValueError(f"wgrad: g {tuple(g.shape)} does not match x "
                         f"{tuple(x.shape)}")
    dw = torch.empty((3, 3, 3, cin, cout), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return dw.zero_()
    lib = load_library()
    n_sm = _sm_count(x.device.index if x.device.index is not None
                     else torch.cuda.current_device())
    plan = launcher_wgrad_plan(lib, b, d, h, w_sz, cin, cout, n_sm)
    ws = torch.empty((plan.splits, 27 * cin, cout), dtype=torch.float32,
                     device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.adell_conv3d_wgrad_bf16(
            x.data_ptr(), g.data_ptr(), ws.data_ptr(), dw.data_ptr(), b, d,
            h, w_sz, cin, cout, plan.tz, plan.ty, plan.tx, n_sm, stream)
    if rc != 0:
        raise RuntimeError(f"conv3d_weight_grad launch failed: cudaError {rc}")
    return dw


def conv3d_weight_grad(x, g):
    """dW [3,3,3,Cin,Cout] of the stride-1 SAME conv of x [B,D,H,W,Cin] with
    cotangent g [B,D,H,W,Cout] (f32 sums rounded once to x's dtype). CUDA
    tensors take the route of ``wgrad_route``: the wgrad kernel, or the
    patch product for the classes it does not take; CPU tensors take the
    plain version."""
    if not _on_card(x, "conv3d_weight_grad"):
        return conv3d_weight_grad_reference(x, g)
    if wgrad_route(x.dtype, x.shape[-1], g.shape[-1]) == "patches":
        conv3d_weight_grad.patch_calls += 1
        return conv3d_weight_grad_reference(x, g)
    dw = _launch_wgrad(x, g)
    conv3d_weight_grad.launches += x.numel() > 0
    return dw


#: wgrad kernel launches and patch-route CUDA calls since the last reset
conv3d_weight_grad.launches = 0
conv3d_weight_grad.patch_calls = 0


class _Conv3dIgemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.has_bias = bias is not None
        return conv3d_igemm(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_igemm_dx(g, w)
        if ctx.needs_input_grad[1]:
            dw = conv3d_weight_grad(x, g).to(w.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 1, 2, 3), dtype=torch.float32).to(g.dtype)
        return dx, dw, db


@torch.library.custom_op("adell::conv3d_igemm", mutates_args=())
def conv3d_igemm_op(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``conv3d_igemm`` as an op that ``torch.export`` records."""
    return conv3d_igemm(x, w, bias)


@conv3d_igemm_op.register_fake
def _(x, w, bias):
    _check_shapes(x, w, bias)
    return x.new_empty((*x.shape[:4], w.shape[-1]))


def conv3d_igemm_train(x, w, bias=None):
    """``conv3d_igemm`` with a gradient: K1 for the forward and for dx.
    Without a gradient, the op ``adell::conv3d_igemm``."""
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, w, bias)
    )
    if not needs_grad:
        return conv3d_igemm_op(x, w, bias)
    return _Conv3dIgemm.apply(x, w, bias)
