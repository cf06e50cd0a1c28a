"""
The host side of ``ops/kernels/build.py``: what it hashes and how it calls
``nvcc``.
No compiler and no card are needed: the build is driven with a stand-in
``nvcc`` that records its arguments.
"""

import stat

from adell_mri_torch.ops.kernels import build


def test_port_sources_and_headers_are_found():
    names = {p.name for p in build._sources()}
    assert {"conv3d_igemm.cu", "conv3d_wgrad.cu", "intensity_aug.cu",
            "flash_attention.cu"} <= names
    assert "wgmma.cuh" in {p.name for p in build._headers()}


def test_every_included_header_is_hashed():
    """Each ``#include "..."`` of a port source names a header under
    ``csrc/`` that the build hashes: the conv and attention kernels share
    ``wgmma.cuh``, so a change to it rebuilds both."""
    import re

    headers = {p.name for p in build._headers()}
    included = set()
    for src in build._sources():
        included |= set(re.findall(r'#include "([^"]+)"', src.read_text()))
    assert included and included <= headers
    for name in ("conv3d_igemm.cu", "flash_attention.cu"):
        assert '#include "wgmma.cuh"' in (build.CSRC_DIR / name).read_text()


def _declared(pattern):
    """Entry points of the port's sources whose name matches ``pattern``,
    with the number of arguments each declares."""
    import re

    declared = {}
    for src in build._sources():
        for m in re.finditer(r'extern "C" int (' + pattern + r")"
                             r"\(([^)]*)\)", src.read_text()):
            declared[m.group(1)] = m.group(2).count(",") + 1
    return declared


def test_single_entry_points_have_signatures():
    """The conv's Hopper entry points and the f32 attention backward's
    preparation have no twin of the other type and are bound by name with
    as many arguments as the source declares: 14 for the conv launcher,
    pointers as pointers."""
    import ctypes

    sig = build._SINGLE["adell_conv3d_wgmma_bf16"]
    assert len(sig) == 14
    assert sig[:4] == [ctypes.c_void_p] * 4 and sig[-1] is ctypes.c_void_p
    declared = _declared(r"adell_conv3d_w\w*|adell_flash_image_f32")
    assert declared == {name: len(s) for name, s in build._SINGLE.items()}


def test_flash_entry_points_have_signatures():
    """The attention entry points, generated for bf16 and f32 by one macro,
    are bound with as many arguments as it declares: each takes the f32
    kernels' workspace after its outputs (null in bf16)."""
    import ctypes
    import re

    source = (build.CSRC_DIR / "flash_attention.cu").read_text()
    declared = {m.group(1): m.group(2).count(",") + 1
                for m in re.finditer(r'extern "C" int (adell_flash_\w+?)'
                                     r"_##SUFFIX\(([^)]*)\)", source)}
    assert declared == {stem: len(sig) for stem, sig
                        in build._SIGNATURES.items()
                        if stem.startswith("adell_flash")}
    assert build._SIGNATURES["adell_flash_fwd"][:7] == [ctypes.c_void_p] * 7
    assert build._SIGNATURES["adell_flash_bwd_dq"][:8] == [ctypes.c_void_p] * 8
    assert (build._SIGNATURES["adell_flash_bwd_dkv"][:9]
            == [ctypes.c_void_p] * 9)
    image = build._SINGLE["adell_flash_image_f32"]
    assert image[0] is ctypes.c_int and image[-1] is ctypes.c_void_p


def test_wgrad_entry_points_have_signatures():
    """The wgrad kernel's launcher (x, g, workspace, dW, then B, D, H, W,
    Cin, Cout, the box and the SM count, then the stream), its limits query
    (Cin, Cout and the output array, as the forward's) and its plan query
    (ten ints and the output array) live in their own source and are bound
    with the arguments it declares."""
    import ctypes

    assert "conv3d_wgrad.cu" in {p.name for p in build._sources()}
    declared = _declared(r"adell_conv3d_wgrad\w*")
    assert declared == {"adell_conv3d_wgrad_bf16": 15,
                        "adell_conv3d_wgrad_limits": 3,
                        "adell_conv3d_wgrad_plan": 11}
    sig = build._SINGLE["adell_conv3d_wgrad_bf16"]
    assert sig[:4] == [ctypes.c_void_p] * 4 and sig[-1] is ctypes.c_void_p
    assert sig[4:14] == [ctypes.c_int] * 10
    assert (build._SINGLE["adell_conv3d_wgrad_limits"]
            == build._SINGLE["adell_conv3d_wgmma_limits"])
    plan = build._SINGLE["adell_conv3d_wgrad_plan"]
    assert plan[:10] == [ctypes.c_int] * 10
    assert plan[10] == ctypes.POINTER(ctypes.c_int)
    assert '#include "wgmma.cuh"' in (
        build.CSRC_DIR / "conv3d_wgrad.cu").read_text()


def test_tf32_entry_points_have_signatures():
    """The 3xTF32 conv's launcher (x, the prepared weight, bias, out, then
    B, D, H, W, Cin, Cout and the box, then the stream: the bf16 wgmma
    launcher's arguments) and its limits query (Cin, Cout and the output
    array of three: voxels a box, most halo rows, Cout_pad) live in their
    own source, include ``wgmma.cuh``, and are bound with the arguments it
    declares."""
    import ctypes

    assert "conv3d_tf32.cu" in {p.name for p in build._sources()}
    declared = _declared(r"adell_conv3d_wgmma_tf32x3\w*")
    assert declared == {"adell_conv3d_wgmma_tf32x3": 14,
                        "adell_conv3d_wgmma_tf32x3_limits": 3}
    sig = build._SINGLE["adell_conv3d_wgmma_tf32x3"]
    assert sig == build._SINGLE["adell_conv3d_wgmma_bf16"]
    assert sig[:4] == [ctypes.c_void_p] * 4 and sig[-1] is ctypes.c_void_p
    assert sig[4:13] == [ctypes.c_int] * 9
    limits = build._SINGLE["adell_conv3d_wgmma_tf32x3_limits"]
    assert limits == [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    source = (build.CSRC_DIR / "conv3d_tf32.cu").read_text()
    assert '#include "wgmma.cuh"' in source
    assert "cvt.rna.tf32.f32" in source


def test_paired_entry_points_have_signatures():
    """The conv's entry points with a bf16 and an f32 twin are bound with as
    many arguments as the source declares for both: the narrow launcher
    takes 11 (pointers and the stream as pointers), its plan 3."""
    import ctypes
    import re

    source = (build.CSRC_DIR / "conv3d_igemm.cu").read_text()
    declared = {}
    for m in re.finditer(r'extern "C" int (adell_\w+)_(bf16|f32)'
                         r"\(([^)]*)\)", source):
        declared.setdefault(m.group(1), {})[m.group(2)] = (
            m.group(3).count(",") + 1)
    paired = {stem: n["bf16"] for stem, n in declared.items()
              if n.keys() == {"bf16", "f32"} and n["bf16"] == n["f32"]}
    assert paired == {stem: len(sig) for stem, sig
                      in build._SIGNATURES.items()
                      if stem.startswith("adell_conv3d")}
    assert set(paired) == {"adell_conv3d_igemm", "adell_conv3d_narrow",
                           "adell_conv3d_narrow_plan"}
    sig = build._SIGNATURES["adell_conv3d_narrow"]
    assert len(sig) == 11
    assert sig[:4] == [ctypes.c_void_p] * 4 and sig[-1] is ctypes.c_void_p
    assert len(build._SIGNATURES["adell_conv3d_narrow_plan"]) == 3


def test_hash_follows_a_header(tmp_path, monkeypatch):
    """A changed header must rebuild: the hash covers ``*.cuh`` content."""
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("#define N 1\n")
    first = build._source_hash(build._sources(), build._headers())
    assert first == build._source_hash(build._sources(), build._headers())
    (tmp_path / "h.cuh").write_text("#define N 2\n")
    second = build._source_hash(build._sources(), build._headers())
    assert second != first
    # the sources alone hash to something else: the header is in it
    assert build._source_hash(build._sources()) not in (first, second)


def test_hash_follows_the_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    (tmp_path / "a.cu").write_text("int x;\n")
    before = build._source_hash(build._sources(), build._headers())
    monkeypatch.setattr(build, "NVCC_FLAGS", [*build.NVCC_FLAGS, "-DX=1"])
    assert build._source_hash(build._sources(), build._headers()) != before


def test_compile_puts_csrc_on_the_include_path(tmp_path, monkeypatch):
    """One compiler call per source with ``-I csrc`` and the Hopper target,
    then one link."""
    csrc, out = tmp_path / "csrc", tmp_path / "out"
    csrc.mkdir()
    out.mkdir()
    (csrc / "a.cu").write_text("")
    (csrc / "b.cu").write_text("")
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {calls}\n'
        'while [ $# -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then touch "$2"; fi\n'
        "  shift\n"
        "done\n"
    )
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    build._compile(str(nvcc), build._sources(), out / build.LIB_NAME)
    lines = calls.read_text().splitlines()
    compiles = [ln for ln in lines if " -c " in ln]
    assert len(compiles) == 2 and len(lines) == 3
    for ln in compiles:
        assert f"-I {csrc}" in ln and "arch=compute_90a,code=sm_90a" in ln
    assert "-shared" in lines[-1] and "-lcuda" not in lines[-1]
    assert (out / build.LIB_NAME).exists()


def test_sass_loop_counts_the_widest_backward_branch():
    """``tools/sass_loop.py`` reads a cuobjdump listing: the loop body runs
    from the target of the branch that jumps furthest back to it."""
    from adell_mri_torch.tools.sass_loop import loop_body, parse_functions

    listing = "\n".join([
        "        Function : _ZN12_GLOBAL__N_120intensity_aug_kernelIfLb1ELb1EEEv",
        "        /*0000*/                   MOV R1, c[0x0][0x28] ;  /* 0x0 */",
        "        /*0010*/              @P0 EXIT ;                   /* 0x0 */",
        "        /*0020*/                   FADD R3, R4, R5 ;       /* 0x0 */",
        "        /*0030*/              @!P1 BRA 0x50 ;              /* 0x0 */",
        "        /*0040*/                   FMUL R3, R3, R3 ;       /* 0x0 */",
        "        /*0050*/              @P3 BRA 0x40 ;               /* 0x0 */",
        "        /*0060*/              @P2 BRA 0x20 ;               /* 0x0 */",
        "        /*0070*/                   EXIT ;                  /* 0x0 */",
        "        Function : other",
        "        /*0000*/                   EXIT ;                  /* 0x0 */",
    ])
    funcs = parse_functions(listing)
    assert [len(v) for v in funcs.values()] == [8, 1]
    body = loop_body(next(iter(funcs.values())))
    assert [a for a, _ in body] == [0x20, 0x30, 0x40, 0x50, 0x60]
