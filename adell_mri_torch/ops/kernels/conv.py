"""
3x3x3 stride-1 SAME 3D convolution forward on a hand-written Hopper kernel.

Counterpart of ``adell_mri_tpu/ops/pallas/conv.py``: the CUDA kernel in
``adell_mri_torch/csrc/conv3d_igemm.cu`` replaces that module's ``_kernel``
(the TPU implicit-GEMM conv). It is an implicit GEMM over M = B*D*H*W
voxels, N = Cout and K = 27*Cin whose patch matrix is gathered tile by
tile into shared memory and never written to device memory, with bf16
tensor-core products (f32 FMA for f32 inputs), f32 accumulation and the
bias fused into the epilogue. The source's header says what bounds it on
the H100 and what its design does about that.

``conv3d_igemm`` launches the kernel for CUDA tensors and runs the plain
version, ``conv3d_igemm_reference``, only for CPU tensors. Unlike the TPU
kernel it has no shape gate: every Cin/Cout and spatial size is taken.

``conv3d_igemm_train`` is the differentiable form, mirroring
``_conv3d_im2col_bwd`` in ``adell_mri_tpu/ops/conv.py`` for stride 1 and
SAME: dx is the same kernel (``conv3d_igemm_dx``) on the cotangent with
the spatially flipped, channel-swapped weight; dW is the patch tensor
contracted with the cotangent in one ``torch.matmul`` (the JAX package
computes it outside any Pallas kernel too); dbias is the cotangent's sum.
On CPU tensors forward and backward both take the plain version.
"""

import torch
import torch.nn.functional as F

from adell_mri_torch.ops.kernels.build import load_library

_LAUNCHERS = {
    torch.bfloat16: "adell_conv3d_igemm_bf16",
    torch.float32: "adell_conv3d_igemm_f32",
}


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


def _check(x, w, bias):
    if x.dim() != 5:
        raise ValueError(f"x must be [B,D,H,W,Cin], got {tuple(x.shape)}")
    cin = x.shape[-1]
    if w.dim() != 5 or tuple(w.shape[:4]) != (3, 3, 3, cin):
        raise ValueError(
            f"w must be [3,3,3,{cin},Cout] for x {tuple(x.shape)}, got "
            f"{tuple(w.shape)}"
        )
    if x.dtype not in _LAUNCHERS:
        raise TypeError(f"conv3d_igemm takes bf16 or f32, got {x.dtype}")
    tensors = [("x", x), ("w", w)]
    if bias is not None:
        if tuple(bias.shape) != (w.shape[-1],):
            raise ValueError(
                f"bias must be [{w.shape[-1]}], got {tuple(bias.shape)}"
            )
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
    _check(x, w, bias)
    b, d, h, w_sz, cin = x.shape
    cout = w.shape[-1]
    out = torch.empty((b, d, h, w_sz, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out, False
    launcher = getattr(load_library(), _LAUNCHERS[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = launcher(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(),
            out.data_ptr(), b, d, h, w_sz, cin, cout, stream,
        )
    if rc != 0:
        raise RuntimeError(f"conv3d_igemm launch failed: cudaError {rc}")
    return out, True


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
    out, launched = _launch(x, w, bias)
    conv3d_igemm.launches += launched
    return out


#: forward launches since the last reset (set to 0 to start a count)
conv3d_igemm.launches = 0


def conv3d_igemm_dx(g, w):
    """Input gradient of the stride-1 SAME conv: the same kernel on the
    cotangent ``g`` [B,D,H,W,Cout] with ``w`` flipped in space and its
    channel axes swapped (``[3,3,3,Cout,Cin]``). Counted apart from the
    forward launches."""
    w_rot = w.flip(0, 1, 2).transpose(3, 4).contiguous()
    if not _on_card(g, "conv3d_igemm_dx"):
        return conv3d_igemm_reference(g, w_rot)
    dx, launched = _launch(g, w_rot, None)
    conv3d_igemm_dx.launches += launched
    return dx


#: backward (dx) launches since the last reset
conv3d_igemm_dx.launches = 0


def conv3d_weight_grad(x, g):
    """dW [3,3,3,Cin,Cout] of the stride-1 SAME conv: the padded input's
    patch tensor [V, 27*Cin] contracted with ``g`` [V, Cout] over the
    voxels in one product (f32 accumulation rounded once to x's dtype). The
    patch tensor is transient: 27x the input, 3.6 GB at the flagship stem
    in bf16."""
    b, d, h, w_sz, cin = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    # [B,D,H,W,Cin,3,3,3] -> [B,D,H,W,3,3,3,Cin]: k = tap*Cin + ci, the
    # row-major flattening of the weight
    patches = (
        xp.unfold(1, 3, 1).unfold(2, 3, 1).unfold(3, 3, 1)
        .permute(0, 1, 2, 3, 5, 6, 7, 4)
        .reshape(-1, 27 * cin)
    )
    # bf16 products summed in f32 and rounded once, as the JAX package's
    # preferred_element_type=f32: cuBLAS may otherwise reduce its split-K
    # partial sums in bf16
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        dw = torch.matmul(patches.t(), g.reshape(-1, g.shape[-1]))
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced
    return dw.reshape(3, 3, 3, cin, g.shape[-1])


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


def conv3d_igemm_train(x, w, bias=None):
    """``conv3d_igemm`` with a gradient: K1 for the forward and for dx."""
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, w, bias)
    )
    if not needs_grad:
        return conv3d_igemm(x, w, bias)
    return _Conv3dIgemm.apply(x, w, bias)
