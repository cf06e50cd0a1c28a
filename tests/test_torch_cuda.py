"""
The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and ``nvcc``; elsewhere they skip. Run them
on the card with ``python -m pytest --noconftest -m gpu
tests/test_torch_cuda.py`` (the shared conftest imports JAX, which the
card's machine does not need). Tolerances: one bf16 ulp of the output
scale for bf16 (both sides sum in f32 and round once), 1e-4 of it for f32
on any route and 1e-5 on the 3xTF32 route, as in ``chip_smoke.py``; for
the gradients one bf16 ulp and 1e-3 in f32 with TF32 off. The attention kernels: 2e-5 (forward) and 1e-4 (backward)
of the scale in f32 (summation order; all three on 3xTF32 kernels,
whose preparation kernel is held to its plain version bit for bit); one
bf16 ulp (2^-7) of the scale in
bf16, where kernel and plain version both round p and ds to bf16 once, the
kernel against its running maximum and the plain version against the final
one.
"""

import pytest
import torch

from adell_mri_torch.ops.kernels import attention as kattn
from adell_mri_torch.ops.kernels import conv as kconv
from adell_mri_torch.ops.kernels import intensity as kint


@pytest.fixture
def cuda():
    """The card, with TF32 off: the plain version is cuDNN's f32 conv,
    which otherwise rounds its inputs to TF32 (about 1e-3 relative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cudnn.allow_tf32
    saved_mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = saved
    torch.backends.cuda.matmul.allow_tf32 = saved_mm


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "shape",
    [
        (2, 5, 6, 7, 3, 5),
        (1, 4, 4, 4, 1, 1),
        (2, 6, 6, 6, 16, 70),
        (1, 3, 5, 7, 24, 40),
        (3, 9, 10, 11, 8, 33),
    ],
)
def test_conv3d_igemm_matches_plain(cuda, shape, dtype):
    b, d, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((b, d, h, w, cin), generator=g, device=cuda).to(dtype)
    wt = torch.randn((3, 3, 3, cin, cout), generator=g, device=cuda)
    wt = (wt / (27 * cin) ** 0.5).to(dtype)
    bias = torch.randn(cout, generator=g, device=cuda).to(dtype)
    before = kconv.conv3d_igemm.launches
    got = kconv.conv3d_igemm(x, wt, bias)
    assert kconv.conv3d_igemm.launches == before + 1
    want = kconv.conv3d_igemm_reference(x, wt, bias)
    torch.cuda.synchronize()
    scale = max(float(want.float().abs().max()), 1.0)
    tol = (2.0**-7 if dtype == torch.bfloat16 else 1e-4) * scale
    assert got.dtype == dtype and got.shape == want.shape
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape",
    [
        (1, 7, 9, 5, 16, 16),
        (1, 7, 9, 5, 48, 24),
        (2, 8, 8, 2, 128, 256),
        (1, 5, 6, 10, 32, 16),
        (2, 6, 6, 6, 64, 64),
        (1, 9, 4, 3, 256, 8),
    ],
)
def test_conv3d_wgmma_route_matches_plain(cuda, shape):
    """The Hopper route (bf16, Cin a multiple of 16, Cout of 8) at ragged
    volumes, chunked channels and padded N blocks, forward and dx."""
    b, d, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((b, d, h, w, cin), generator=g,
                    device=cuda).to(torch.bfloat16)
    wt = (torch.randn((3, 3, 3, cin, cout), generator=g, device=cuda)
          / (27 * cin) ** 0.5).to(torch.bfloat16)
    bias = torch.randn(cout, generator=g, device=cuda).to(torch.bfloat16)
    gy = torch.randn((b, d, h, w, cout), generator=g,
                     device=cuda).to(torch.bfloat16)
    before = (kconv.conv3d_igemm.wgmma_launches,
              kconv.conv3d_igemm_dx.wgmma_launches)
    got = kconv.conv3d_igemm(x, wt, bias)
    dx = kconv.conv3d_igemm_dx(gy, wt)
    assert kconv.conv3d_igemm.wgmma_launches == before[0] + 1
    want = kconv.conv3d_igemm_reference(x, wt, bias)
    w_rot = wt.flip(0, 1, 2).transpose(3, 4).contiguous()
    want_dx = kconv.conv3d_igemm_reference(gy, w_rot)
    torch.cuda.synchronize()
    if cout % 16 == 0:
        assert kconv.conv3d_igemm_dx.wgmma_launches == before[1] + 1
    for a, r in ((got, want), (dx, want_dx)):
        scale = max(float(r.float().abs().max()), 1.0)
        assert float((a.float() - r.float()).abs().max()) <= 2.0**-7 * scale


@pytest.mark.gpu
def test_wgmma_limits_are_the_launchers(cuda):
    """``adell_conv3d_wgmma_limits`` of the shipped build, worked out by
    hand: the CPU tests' box and tightest halo limit (256->256); 32->32, a
    ring of four 6 KB stages beside one buffer of 80-byte rows; 48->24,
    three chunks of 16 (two buffers of 48-byte rows) and four 9 KB stages
    of nine taps. The launcher takes the box ``wgmma_box`` picks and
    refuses one of another size."""
    import ctypes

    from adell_mri_torch.ops.kernels.build import load_library

    lib = load_library()
    got = (ctypes.c_int * 2)()
    for cin, cout, want in [(256, 256, [128, 576]), (32, 32, [128, 2585]),
                            (48, 24, [128, 2026])]:
        assert lib.adell_conv3d_wgmma_limits(cin, cout, got) == 0
        assert list(got) == want
    assert lib.adell_conv3d_wgmma_limits(8, 16, got) != 0
    assert kconv.wgmma_box(lib, 16, 16, 4, 256, 256) == (4, 8, 4)
    x = torch.zeros((1, 4, 4, 8, 16), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((3, 3, 3, 16, 16), dtype=torch.bfloat16, device=cuda)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert lib.adell_conv3d_wgmma_bf16(
        x.data_ptr(), w.data_ptr(), None, out.data_ptr(), 1, 4, 4, 8, 16, 16,
        2, 4, 8, stream) != 0


# f32 classes of the tf32 route (B, D, H, W, Cin, Cout): the U-Net's
# 128x128x32 ones and a level below, UNETR's full-size 32->16 and 16->16,
# 256->256 at 16x16x4, ragged volumes with chunks of 16, 8 and a padded N
# block, two N blocks of 128, and a volume smaller than one box
TF32_SHAPES = [
    (4, 128, 128, 32, 32, 32), (4, 128, 128, 32, 64, 32),
    (4, 128, 128, 32, 64, 64), (4, 32, 32, 8, 128, 64),
    (1, 256, 256, 64, 32, 16), (1, 256, 256, 64, 16, 16),
    (4, 16, 16, 4, 256, 256), (1, 7, 9, 5, 16, 16), (1, 7, 9, 5, 48, 24),
    (2, 3, 5, 7, 8, 24), (2, 8, 8, 2, 128, 256), (1, 1, 2, 3, 8, 8),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", TF32_SHAPES, ids=str)
def test_conv3d_tf32_route_matches_plain(cuda, shape):
    """The 3xTF32 kernel, forward and dx, within 1e-5 of the output scale of
    the plain version with TF32 off (one TF32 pass is about 3e-4 off), the
    same bits over two runs, each launch counted on the tf32 route."""
    b, d, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((b, d, h, w, cin), generator=g, device=cuda)
    wt = torch.randn((3, 3, 3, cin, cout), generator=g,
                     device=cuda) / (27 * cin) ** 0.5
    bias = torch.randn(cout, generator=g, device=cuda)
    gy = torch.randn((b, d, h, w, cout), generator=g, device=cuda)
    before = (kconv.conv3d_igemm.tf32_launches,
              kconv.conv3d_igemm_dx.tf32_launches)
    got = kconv.conv3d_igemm(x, wt, bias)
    dx = kconv.conv3d_igemm_dx(gy, wt)
    assert (kconv.conv3d_igemm.tf32_launches,
            kconv.conv3d_igemm_dx.tf32_launches) == (before[0] + 1,
                                                     before[1] + 1)
    assert torch.equal(got, kconv.conv3d_igemm(x, wt, bias))
    assert torch.equal(dx, kconv.conv3d_igemm_dx(gy, wt))
    w_rot = wt.flip(0, 1, 2).transpose(3, 4).contiguous()
    for a, r in ((got, kconv.conv3d_igemm_reference(x, wt, bias)),
                 (dx, kconv.conv3d_igemm_reference(gy, w_rot))):
        torch.cuda.synchronize()
        assert a.dtype == torch.float32 and a.shape == r.shape
        assert float((a - r).abs().max()) <= 1e-5 * float(r.abs().max())


@pytest.mark.gpu
def test_same_conv_weights_keeps_the_bits(cuda):
    """Launches inside a ``same_conv_weights`` block, which share one
    prepared weight, give the bits of a launch outside it."""
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((2, 16, 16, 8, 32), generator=g, device=cuda)
    wt = torch.randn((3, 3, 3, 32, 64), generator=g,
                     device=cuda) / (27 * 32) ** 0.5
    want = kconv.conv3d_igemm(x, wt)
    with kconv.same_conv_weights():
        first = kconv.conv3d_igemm(x, wt)
        again = kconv.conv3d_igemm(x, wt)
    assert torch.equal(first, want) and torch.equal(again, want)


@pytest.mark.gpu
def test_tf32_limits_are_the_launchers(cuda):
    """``adell_conv3d_wgmma_tf32x3_limits`` gives what ``tf32_plan``, the
    Python mirror of the shipped build, works out (voxels a box, most halo
    rows, Cout_pad), refuses widths that are not multiples of 8, and the
    launcher refuses a box of another size; the weight the wrapper prepares
    on the card has the CPU's bits."""
    import ctypes

    from adell_mri_torch.ops.kernels.build import load_library

    lib = load_library()
    got = (ctypes.c_int * 3)()
    for cin, cout in [(8, 8), (16, 16), (32, 32), (32, 16), (48, 24),
                      (64, 64), (128, 64), (256, 256), (8, 24), (24, 136)]:
        assert lib.adell_conv3d_wgmma_tf32x3_limits(cin, cout, got) == 0
        plan = kconv.tf32_plan(cin, cout)
        assert list(got) == [plan.voxels, plan.max_halo_rows, plan.cout_pad]
        assert kconv.tf32_limits(lib, cin, cout) == tuple(got)
    for cin, cout in [(12, 16), (8, 12), (4, 8)]:
        assert lib.adell_conv3d_wgmma_tf32x3_limits(cin, cout, got) != 0
    x = torch.zeros((1, 4, 4, 8, 16), device=cuda)
    wk = torch.zeros((2, 27, 16, 16), device=cuda)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert lib.adell_conv3d_wgmma_tf32x3(
        x.data_ptr(), wk.data_ptr(), None, out.data_ptr(), 1, 4, 4, 8, 16,
        16, 2, 4, 8, stream) != 0
    w = torch.randn((3, 3, 3, 48, 24), device=cuda)
    assert torch.equal(kconv.tf32_split_weight(w, 32).cpu(),
                       kconv.tf32_split_weight(w.cpu(), 32))


# chip_smoke.py's narrow rows (B, D, H, W, Cin, Cout): the U-Net stems and
# the dx of 1->32 at B=4, UNETR's image conv at B=1 and 2, multi-sequence
# stems, ragged volumes
NARROW_SHAPES = [
    (4, 128, 128, 32, 1, 1), (4, 128, 128, 32, 1, 32),
    (4, 128, 128, 32, 32, 1), (1, 256, 256, 64, 1, 16),
    (2, 256, 256, 64, 1, 16), (4, 128, 128, 32, 3, 3),
    (4, 128, 128, 32, 3, 32), (4, 128, 128, 32, 32, 3),
    (1, 7, 9, 5, 1, 16), (1, 7, 9, 5, 3, 8), (1, 7, 9, 5, 24, 1),
]


def _narrow_inputs(shape, dtype, device, seed):
    b, d, h, w, cin, cout = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, d, h, w, cin), generator=g, device=device).to(dtype)
    wt = (torch.randn((3, 3, 3, cin, cout), generator=g, device=device)
          / (27 * cin) ** 0.5).to(dtype)
    bias = (0.1 * torch.randn(cout, generator=g, device=device)).to(dtype)
    gy = torch.randn((b, d, h, w, cout), generator=g,
                     device=device).to(dtype)
    return x, wt, bias, gy


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", NARROW_SHAPES, ids=str)
def test_conv3d_narrow_route_matches_plain(cuda, shape, dtype):
    """The narrow kernel, forward and dx (whose Cout -> Cin is narrow too),
    against the plain version; in bf16 the same bits from two runs."""
    x, wt, bias, gy = _narrow_inputs(shape, dtype, cuda, 8)
    before = (kconv.conv3d_igemm.narrow_launches,
              kconv.conv3d_igemm_dx.narrow_launches)
    got = [kconv.conv3d_igemm(x, wt, bias), kconv.conv3d_igemm_dx(gy, wt)]
    assert (kconv.conv3d_igemm.narrow_launches,
            kconv.conv3d_igemm_dx.narrow_launches) == (before[0] + 1,
                                                       before[1] + 1)
    again = [kconv.conv3d_igemm(x, wt, bias), kconv.conv3d_igemm_dx(gy, wt)]
    w_rot = wt.flip(0, 1, 2).transpose(3, 4).contiguous()
    want = [kconv.conv3d_igemm_reference(x, wt, bias),
            kconv.conv3d_igemm_reference(gy, w_rot)]
    torch.cuda.synchronize()
    rel = 2.0**-7 if dtype == torch.bfloat16 else 1e-4
    for a, a2, r in zip(got, again, want):
        assert a.dtype == dtype and a.shape == r.shape
        scale = max(float(r.float().abs().max()), 1.0)
        assert float((a.float() - r.float()).abs().max()) <= rel * scale
        if dtype == torch.bfloat16:
            assert torch.equal(a, a2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", NARROW_SHAPES, ids=str)
def test_conv3d_narrow_gradient_matches_plain(cuda, shape, dtype):
    """dx (on the narrow kernel), dW and dbias of ``conv3d_igemm_train``
    against autograd through the plain version."""
    x, wt, bias, gy = _narrow_inputs(shape, dtype, cuda, 9)
    grads = []
    for fn in (kconv.conv3d_igemm_train, kconv.conv3d_igemm_reference):
        leaves = [t.clone().requires_grad_() for t in (x, wt, bias)]
        y = fn(*leaves)
        before = kconv.conv3d_igemm_dx.narrow_launches
        grads.append(torch.autograd.grad(y, leaves, gy))
        if fn is kconv.conv3d_igemm_train:
            assert kconv.conv3d_igemm_dx.narrow_launches == before + 1
    torch.cuda.synchronize()
    rel = 2.0**-7 if dtype == torch.bfloat16 else 1e-3
    for got, want in zip(*grads):
        scale = max(float(want.float().abs().max()), 1e-30)
        assert float((got.float() - want.float()).abs().max()) <= rel * scale


#: (itemsize, Cin, Cout) -> (tz, ty, tx, cot, cs, civ), worked out by hand
#: (the table of tests/test_torch_conv.py, whose numpy emulation follows it)
NARROW_PLANS = {
    (2, 1, 1): (4, 8, 32, 1, 1, 1), (2, 1, 32): (4, 2, 32, 8, 4, 1),
    (2, 32, 1): (4, 8, 32, 1, 1, 8), (4, 32, 1): (4, 8, 32, 1, 1, 4),
    (2, 1, 16): (4, 4, 32, 8, 2, 1), (2, 3, 3): (4, 8, 32, 4, 1, 4),
    (2, 3, 32): (4, 2, 32, 8, 4, 4), (2, 32, 3): (4, 8, 32, 4, 1, 8),
    (4, 4, 64): (4, 1, 32, 8, 8, 4), (2, 24, 1): (4, 8, 32, 1, 1, 8),
    (2, 1, 24): (4, 2, 32, 8, 3, 1),
}


@pytest.mark.gpu
def test_narrow_plan_is_the_launchers(cuda):
    """``adell_conv3d_narrow_plan`` gives the decomposition the CPU tests
    emulate, and the launchers refuse convs outside the narrow set."""
    import ctypes

    from adell_mri_torch.ops.kernels.build import load_library

    lib = load_library()
    got = (ctypes.c_int * 6)()
    for (itemsize, cin, cout), plan in NARROW_PLANS.items():
        fn = (lib.adell_conv3d_narrow_plan_bf16 if itemsize == 2
              else lib.adell_conv3d_narrow_plan_f32)
        assert fn(cin, cout, got) == 0
        assert tuple(got) == plan
    x = torch.zeros((1, 4, 4, 8, 8), dtype=torch.bfloat16, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for cin, cout in ((8, 8), (1, 128), (65, 1)):
        assert lib.adell_conv3d_narrow_plan_bf16(cin, cout, got) != 0
        assert lib.adell_conv3d_narrow_bf16(
            x.data_ptr(), x.data_ptr(), None, x.data_ptr(), 1, 4, 4, 8, cin,
            cout, stream) != 0


@pytest.mark.gpu
def test_conv3d_igemm_rejects_strided_input(cuda):
    x = torch.zeros((1, 4, 4, 4, 8), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError):
        kconv.conv3d_igemm(x, torch.zeros((3, 3, 3, 8, 8), device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "shape", [(2, 5, 6, 7, 3, 5), (1, 8, 8, 4, 32, 1), (2, 6, 6, 6, 16, 40)]
)
def test_conv3d_igemm_gradient_matches_plain(cuda, shape, dtype):
    """The repair: the kernel's Function gives dx (on the kernel), dW and
    dbias equal to autograd through the plain version."""
    b, d, h, w, cin, cout = shape
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((b, d, h, w, cin), generator=g, device=cuda).to(dtype)
    wt = (torch.randn((3, 3, 3, cin, cout), generator=g, device=cuda)
          / (27 * cin) ** 0.5).to(dtype)
    bias = torch.randn(cout, generator=g, device=cuda).to(dtype)
    gy = torch.randn((b, d, h, w, cout), generator=g, device=cuda).to(dtype)
    grads = []
    for fn in (kconv.conv3d_igemm_train, kconv.conv3d_igemm_reference):
        leaves = [t.clone().requires_grad_() for t in (x, wt, bias)]
        y = fn(*leaves)
        before = kconv.conv3d_igemm_dx.launches
        grads.append(torch.autograd.grad(y, leaves, gy))
        if fn is kconv.conv3d_igemm_train:
            assert y.grad_fn is not None
            assert kconv.conv3d_igemm_dx.launches == before + 1
    torch.cuda.synchronize()
    for got, want in zip(*grads):
        assert got.dtype == dtype and got.shape == want.shape
        scale = max(float(want.float().abs().max()), 1e-30)
        rel = 2.0**-7 if dtype == torch.bfloat16 else 1e-3
        assert float((got.float() - want.float()).abs().max()) <= rel * scale


# dW classes (B, D, H, W, Cin, Cout): the U-Net's at B=4 (its three
# 128x128x32 classes, two levels below), UNETR's full-size ones at B=1,
# ragged volumes with several channel chunks, a padded N block, two N
# blocks of 128, and a volume smaller than one box
WGRAD_SHAPES = [
    (4, 128, 128, 32, 32, 32), (4, 128, 128, 32, 64, 32),
    (4, 128, 128, 32, 64, 64), (4, 64, 64, 16, 32, 32),
    (4, 16, 16, 4, 256, 256), (4, 8, 8, 2, 128, 256),
    (1, 256, 256, 64, 32, 16), (1, 256, 256, 64, 16, 16),
    (1, 7, 9, 5, 48, 24), (2, 12, 10, 9, 96, 32), (1, 7, 9, 5, 16, 8),
    (3, 5, 6, 10, 32, 136), (1, 1, 2, 3, 64, 64),
]


def _wgrad_inputs(shape, device, seed):
    b, d, h, w, cin, cout = shape
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, d, h, w, cin), generator=g,
                    device=device).to(torch.bfloat16)
    gy = torch.randn((b, d, h, w, cout), generator=g,
                     device=device).to(torch.bfloat16)
    return x, gy


@pytest.mark.gpu
@pytest.mark.parametrize("shape", WGRAD_SHAPES, ids=str)
def test_conv3d_wgrad_matches_plain(cuda, shape):
    """The wgrad kernel against the patch product (both f32 sums rounded
    once: one bf16 ulp of the scale), and the same bits from two runs."""
    x, gy = _wgrad_inputs(shape, cuda, 10)
    before = (kconv.conv3d_weight_grad.launches,
              kconv.conv3d_weight_grad.patch_calls)
    got = kconv.conv3d_weight_grad(x, gy)
    assert (kconv.conv3d_weight_grad.launches,
            kconv.conv3d_weight_grad.patch_calls) == (before[0] + 1,
                                                      before[1])
    again = kconv.conv3d_weight_grad(x, gy)
    want = kconv.conv3d_weight_grad_reference(x, gy)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    scale = max(float(want.float().abs().max()), 1e-30)
    assert float((got.float() - want.float()).abs().max()) <= 2.0**-7 * scale
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_wgrad_plan_is_the_launchers(cuda):
    """``adell_conv3d_wgrad_limits`` gives the limits that
    ``wgrad_limits`` works out, and ``adell_conv3d_wgrad_plan`` the
    decomposition that ``wgrad_plan`` (the CPU tests' emulation) works out,
    on this card and on one of 132 SMs; both refuse classes outside the
    kernel's, and the plan refuses a box that is not 256 voxels or whose
    halo does not fit."""
    import ctypes

    from adell_mri_torch.ops.kernels.build import load_library

    lib = load_library()
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    limits = (ctypes.c_int * 2)()
    for shape in WGRAD_SHAPES:
        assert lib.adell_conv3d_wgrad_limits(*shape[4:], limits) == 0
        assert tuple(limits) == kconv.wgrad_limits(*shape[4:])
        for sms in (n_sm, 132, 1):
            assert kconv.launcher_wgrad_plan(lib, *shape, sms) == (
                kconv.wgrad_plan(*shape, sms))
    got = (ctypes.c_int * 13)()
    for cin, cout in ((8, 16), (16, 4), (16, 264), (1, 32)):
        assert lib.adell_conv3d_wgrad_limits(cin, cout, limits) != 0
        assert lib.adell_conv3d_wgrad_plan(1, 8, 8, 8, cin, cout, 4, 8, 8,
                                           132, got) != 0
    # 32->32 takes at most 1241 halo rows: 3 x 3 x 258 do not fit
    for box in ((4, 8, 4), (4, 8, 16), (1, 1, 256)):
        assert lib.adell_conv3d_wgrad_plan(1, 8, 8, 8, 32, 32, *box, 132,
                                           got) != 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 6, 6, 6, 16, 40), (1, 7, 9, 5, 48, 24),
                                   (1, 8, 8, 4, 32, 1), (2, 5, 6, 7, 3, 5)],
                         ids=str)
def test_weight_grad_function_matches_plain(cuda, shape):
    """The Function's dW in bf16 on the card: the kernel for its classes,
    the patch product for the others (Cout 1, Cin 3), each counted, and
    equal to autograd through the plain version within one bf16 ulp."""
    x, gy = _wgrad_inputs(shape, cuda, 11)
    cin, cout = shape[-2:]
    wt = (torch.randn((3, 3, 3, cin, cout), device=cuda)
          / (27 * cin) ** 0.5).to(torch.bfloat16)
    route = kconv.wgrad_route(torch.bfloat16, cin, cout)
    grads = []
    for fn in (kconv.conv3d_igemm_train, kconv.conv3d_igemm_reference):
        w = wt.clone().requires_grad_()
        y = fn(x, w)
        before = (kconv.conv3d_weight_grad.launches,
                  kconv.conv3d_weight_grad.patch_calls)
        grads.append(torch.autograd.grad(y, [w], gy)[0])
        if fn is kconv.conv3d_igemm_train:
            assert (kconv.conv3d_weight_grad.launches - before[0],
                    kconv.conv3d_weight_grad.patch_calls - before[1]) == (
                (1, 0) if route == "wgmma" else (0, 1))
    torch.cuda.synchronize()
    got, want = grads
    scale = max(float(want.float().abs().max()), 1e-30)
    assert float((got.float() - want.float()).abs().max()) <= 2.0**-7 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_intensity_aug_matches_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = (torch.rand((3, 16, 16, 8, 1), generator=g, device=cuda)
         - 0.3).to(dtype)
    xf = x.float()
    par = torch.stack([
        xf.amin(dim=(1, 2, 3, 4)), xf.amax(dim=(1, 2, 3, 4)),
        torch.tensor([0.7, 1.0, 1.4], device=cuda),
        torch.tensor([1.0, 1.1, 0.9], device=cuda),
        torch.tensor([0.0, 0.05, -0.05], device=cuda),
        torch.tensor([0.0, 0.05, 0.05], device=cuda),
    ], dim=1).contiguous()
    seed = torch.tensor([7], dtype=torch.int64, device=cuda)
    before = kint.intensity_aug.launches
    clean = kint.intensity_aug(seed, x, par, noise=False)
    noisy = kint.intensity_aug(seed, x, par, rician=True)
    assert kint.intensity_aug.launches == before + 2
    want = kint.intensity_aug_reference(seed, x, par, False, False)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7 * max(
        float(want.float().abs().max()), 1.0)
    assert float((clean.float() - want.float()).abs().max()) <= tol
    # sample 0 has sigma 0: untouched by the Rician magnitude
    assert torch.equal(noisy[0], clean[0]) and float(noisy[0].min()) < 0
    assert float(noisy[1:].min()) >= 0
    resid = (noisy[1:].float() - clean[1:].float()).abs()
    assert 0 < float(resid.mean()) < 0.2
    # the plain version draws the kernel's Philox stream: the noisy output
    # element by element, both noises, and bit-equal over two runs
    for rician in (True, False):
        got = kint.intensity_aug(seed, x, par, rician=rician)
        again = kint.intensity_aug(seed, x, par, rician=rician)
        want = kint.intensity_aug_reference(seed, x, par, rician, True)
        torch.cuda.synchronize()
        tol_n = 1e-5 if dtype == torch.float32 else 2.0**-7 * max(
            float(want.float().abs().max()), 1.0)
        assert float((got.float() - want.float()).abs().max()) <= tol_n
        assert torch.equal(got, again)


@pytest.mark.gpu
def test_intensity_aug_rejects_bad_inputs(cuda):
    seed = torch.tensor([1], dtype=torch.int64, device=cuda)
    par = torch.zeros((1, 6), device=cuda)
    with pytest.raises(ValueError):
        kint.intensity_aug(seed, torch.zeros((1, 6), device=cuda), par)
    with pytest.raises(ValueError):
        kint.intensity_aug(seed, torch.zeros((1, 8), device=cuda),
                           torch.zeros((2, 6), device=cuda))
    # the grid's y dimension holds the samples: at most 65535
    with pytest.raises(ValueError, match="65535"):
        kint.intensity_aug(seed, torch.zeros((65536, 4), device=cuda),
                           torch.zeros((65536, 6), device=cuda))


# (B, H, Nq, Nkv, D): tile multiples, ragged Nq != Nkv, head dim 32, tiny;
# then the edges of the 64-row tiles on either sequence against 2048 tokens,
# the ragged pair, head dim 32 at a ragged length, and B x H that leaves
# most of the card idle (1 x 1) or overfills one wave of blocks (4 x 8)
TILE_EDGES = (1, 63, 64, 65, 127, 128, 129)
ATTENTION_SHAPES = [
    (1, 2, 256, 256, 64),
    (2, 3, 130, 203, 64),
    (1, 2, 100, 64, 32),
    (1, 1, 5, 3, 32),
    *((1, 2, n, 2048, 64) for n in TILE_EDGES),
    *((1, 2, 2048, n, 64) for n in TILE_EDGES),
    (1, 1, 2050, 2311, 64),
    (1, 3, 2050, 2311, 32),
    (1, 1, 2048, 2048, 64),
    (4, 8, 2048, 2048, 64),
    (4, 8, 1000, 1100, 32),
]


def _attention_inputs(shape, dtype, device, seed):
    b, h, nq, nkv, d = shape
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(n):
        return torch.randn((b, h, n, d), generator=g, device=device).to(dtype)

    return draw(nq), draw(nkv), draw(nkv), draw(nq)


def _within(got, want, rel, floor=1e-30):
    scale = max(float(want.float().abs().max()), floor)
    return float((got.float() - want.float()).abs().max()) <= rel * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ATTENTION_SHAPES, ids=str)
def test_flash_attention_fwd_matches_plain(cuda, shape, dtype):
    q, k, v, _ = _attention_inputs(shape, dtype, cuda, 3)
    scale = shape[-1] ** -0.5
    before = kattn.flash_attention_fwd.launches
    out, m, l = kattn.flash_attention_fwd(q, k, v)
    assert kattn.flash_attention_fwd.launches == before + 1
    want, wm, wl = kattn.flash_attention_fwd_reference(q, k, v, scale)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert m.shape == l.shape == q.shape[:3] + (1,)
    rel = 2.0**-7 if dtype == torch.bfloat16 else 2e-5
    assert float((out.float() - want.float()).abs().max()) <= rel * max(
        float(want.float().abs().max()), 1.0)
    assert float((m - wm).abs().max()) <= 1e-4
    assert float(((l - wl) / wl).abs().max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ATTENTION_SHAPES, ids=str)
def test_flash_attention_bwd_matches_plain(cuda, shape, dtype):
    q, k, v, g = _attention_inputs(shape, dtype, cuda, 4)
    scale = shape[-1] ** -0.5
    out, m, l = kattn.flash_attention_fwd_reference(q, k, v, scale)
    lse, delta = kattn.backward_rows(out, m, l, g)
    before = (kattn.flash_attention_bwd_dq.launches,
              kattn.flash_attention_bwd_dkv.launches)
    dq = kattn.flash_attention_bwd_dq(q, k, v, g, lse, delta, scale)
    dk, dv = kattn.flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale)
    assert (kattn.flash_attention_bwd_dq.launches,
            kattn.flash_attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    wq = kattn.flash_attention_bwd_dq_reference(
        q, k, v, g, lse, delta, scale)
    wk, wv = kattn.flash_attention_bwd_dkv_reference(
        q, k, v, g, lse, delta, scale)
    torch.cuda.synchronize()
    rel = 2.0**-7 if dtype == torch.bfloat16 else 1e-4
    # with one key dq and dk vanish in exact arithmetic and both sides
    # return f32 rounding noise: their scale is floored at 1e-2 of dv's
    floor = 1e-2 * float(wv.float().abs().max())
    for got, want in ((dq, wq), (dk, wk), (dv, wv)):
        assert got.dtype == dtype and got.shape == want.shape
        assert _within(got, want, rel, floor)


@pytest.mark.gpu
def test_flash_attention_gradient_matches_autograd(cuda):
    """The Function's dq, dk, dv (f32) against autograd through the
    materialised softmax."""
    q, k, v, g = _attention_inputs((1, 2, 300, 170, 64), torch.float32,
                                   cuda, 5)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    y = kattn.flash_attention(*leaves)
    assert y.grad_fn is not None
    got = torch.autograd.grad(y, leaves, g)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        kattn.attention_reference(*ref_leaves), ref_leaves, g)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _within(a, b, 1e-4)


@pytest.mark.gpu
def test_flash_attention_rejects_bad_inputs(cuda):
    q = torch.zeros((1, 2, 8, 64), device=cuda)
    with pytest.raises(ValueError):
        kattn.flash_attention_fwd(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError):
        kattn.flash_attention_fwd(q[..., :48].contiguous(),
                                  q[..., :48].contiguous(),
                                  q[..., :48].contiguous())
    with pytest.raises(TypeError):
        kattn.flash_attention_fwd(q, q.bfloat16(), q)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 8, 2048, 2048, 64),
                                   (1, 3, 2050, 2311, 32)], ids=str)
def test_flash_attention_bf16_is_bit_equal_from_run_to_run(cuda, shape):
    """Every output element has one owner and no atomics: forward, dQ and
    dK/dV give the same bits twice."""
    q, k, v, g = _attention_inputs(shape, torch.bfloat16, cuda, 6)
    scale = shape[-1] ** -0.5
    first = kattn.flash_attention_fwd(q, k, v, scale)
    lse, delta = kattn.backward_rows(*first, g)
    first += (kattn.flash_attention_bwd_dq(q, k, v, g, lse, delta, scale),)
    first += kattn.flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale)
    again = kattn.flash_attention_fwd(q, k, v, scale)
    again += (kattn.flash_attention_bwd_dq(q, k, v, g, lse, delta, scale),)
    again += kattn.flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", kattn.HEAD_DIMS)
def test_launch_plan_is_the_launchers(cuda, d, dtype):
    """``launch_plan`` repeats in Python what the C launchers compute."""
    import ctypes

    from adell_mri_torch.ops.kernels.build import load_library

    fn = getattr(load_library(), f"adell_flash_plan_{kattn._SUFFIX[dtype]}")
    for kind, stem in enumerate(kattn._KINDS):
        got = (ctypes.c_int * 5)()
        assert fn(kind, d, got) == 0
        plan = kattn.launch_plan(stem, dtype, 1, 64, 64, d)
        assert list(got) == [plan[k] for k in ("rows", "threads", "smem",
                                               "tile", "image")]
    assert fn(3, d, got) != 0 and fn(0, 48, got) != 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 8, 2048, 2048, 64),
                                   (1, 8, 2050, 2311, 64),
                                   (1, 3, 2050, 2311, 32)], ids=str)
def test_flash_attention_f32_backward_on_tf32x3(cuda, shape):
    """The f32 dQ and dK/dV (3xTF32 kernels) at UNETR's training shape and
    ragged ones: within 1e-4 of the output scale of the plain versions,
    one launch each, and the same bits twice."""
    q, k, v, g = _attention_inputs(shape, torch.float32, cuda, 7)
    scale = shape[-1] ** -0.5
    lse, delta = kattn.backward_rows(
        *kattn.flash_attention_fwd_reference(q, k, v, scale), g)
    args = (q, k, v, g, lse, delta, scale)
    before = (kattn.flash_attention_bwd_dq.launches,
              kattn.flash_attention_bwd_dkv.launches)
    got = (kattn.flash_attention_bwd_dq(*args),
           *kattn.flash_attention_bwd_dkv(*args))
    assert (kattn.flash_attention_bwd_dq.launches,
            kattn.flash_attention_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = (kattn.flash_attention_bwd_dq_reference(*args),
            *kattn.flash_attention_bwd_dkv_reference(*args))
    again = (kattn.flash_attention_bwd_dq(*args),
             *kattn.flash_attention_bwd_dkv(*args))
    torch.cuda.synchronize()
    for a, w, b in zip(got, want, again):
        assert a.dtype == torch.float32 and a.shape == w.shape
        assert _within(a, w, 1e-4)
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 8, 2048, 2048, 64),
                                   (2, 8, 2048, 2048, 64),
                                   (1, 8, 2050, 2311, 64),
                                   (1, 3, 2050, 2311, 32),
                                   (1, 2, 65, 1, 64)], ids=str)
def test_flash_attention_f32_forward_on_tf32x3(cuda, shape):
    """The f32 forward (3xTF32 kernel after its preparation kernel) at
    UNETR's shapes and ragged ones: out within 2e-5 of the output scale of
    the plain version, m within 1e-4 of its scale, l within 1e-4 relative,
    one launch, and the same bits twice."""
    q, k, v, _ = _attention_inputs(shape, torch.float32, cuda, 10)
    scale = shape[-1] ** -0.5
    before = kattn.flash_attention_fwd.launches
    got = kattn.flash_attention_fwd(q, k, v, scale)
    assert kattn.flash_attention_fwd.launches == before + 1
    want = kattn.flash_attention_fwd_reference(q, k, v, scale)
    again = kattn.flash_attention_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    (out, m, l), (w_out, w_m, w_l) = got, want
    assert out.dtype == m.dtype == l.dtype == torch.float32
    assert _within(out, w_out, 2e-5, 1.0)
    assert _within(m, w_m, 1e-4, 1.0)
    assert float(((l - w_l) / w_l).abs().max()) <= 1e-4
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("d", kattn.HEAD_DIMS)
@pytest.mark.parametrize("kind", [0, 1, 2])
def test_tf32x3_image_kernel_matches_plain(cuda, kind, d):
    """The f32 kernels' preparation kernel writes exactly the bits of
    ``flash_tf32x3_image_reference``, ragged last tile and (kind 1) lse,
    delta and the zero tail included."""
    from adell_mri_torch.ops.kernels.build import load_library

    q, k, v, g = _attention_inputs((2, 3, 70, 97, d), torch.float32, cuda, 8)
    gen = torch.Generator(device=cuda).manual_seed(9)
    lse, delta = (torch.randn((2, 3, 70, 1), generator=gen, device=cuda)
                  for _ in range(2))
    a, b = (q, g) if kind == 1 else (k, v)
    want = kattn.flash_tf32x3_image_reference(kind, a, b, lse, delta)
    got = torch.full_like(want, float("nan"))
    rc = load_library().adell_flash_image_f32(
        kind, a.data_ptr(), b.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        got.data_ptr(), 6, a.shape[2], d,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_flash_attention_rejects_a_scale_that_is_not_positive(cuda):
    q = torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="positive finite scale"):
        kattn.flash_attention_fwd(q, q, q, scale=0.0)


@pytest.mark.gpu
def test_crop_augment_on_card_launches_k3_once(cuda):
    """The pos/neg crop on the card: the same crop as on the CPU at an
    injected start, and one K3 launch over the cropped batch."""
    from adell_mri_torch.transforms import pipeline as tpipe
    from adell_mri_torch.transforms import spatial as tS

    g = torch.Generator(device=cuda).manual_seed(0)
    vol = torch.rand((64, 64, 32, 1), generator=g, device=cuda)
    start = torch.tensor([5, 30, 9], device=cuda)
    torch.testing.assert_close(
        tS.dynamic_crop(vol, start, (32, 32, 16)).cpu(),
        tS.dynamic_crop(vol.cpu(), start.cpu(), (32, 32, 16)), rtol=0,
        atol=0)
    label = (vol[..., 0] > 0.9).float()
    fg = torch.nonzero(label)[:64].int()
    n_fg = torch.tensor([fg.shape[0]] * 2, device=cuda, dtype=torch.int32)
    fg = torch.nn.functional.pad(fg, (0, 0, 0, 64 - fg.shape[0]))
    tr = tpipe.SegmentationTransforms(
        augmentations=tpipe.AugmentPolicy.from_flags(
            ["intensity", "noise", "affine", "flip"], scale_range=0.0,
            flip_axes=(0, 1, 2)),
        crop_size=(32, 32, 16), max_fg=64)
    before = kint.intensity_aug.launches
    out = tr.augment(g, {"image": vol[None].expand(2, -1, -1, -1, -1),
                         "label": label[None].expand(2, -1, -1, -1),
                         "fg_indices": fg[None].expand(2, -1, -1),
                         "n_fg": n_fg})
    torch.cuda.synchronize()
    assert kint.intensity_aug.launches == before + 1
    assert tuple(out["image"].shape) == (2, 32, 32, 16, 1)
    assert tuple(out["label"].shape) == (2, 32, 32, 16)
    assert bool(torch.isfinite(out["image"]).all())
