"""
Builds the port's CUDA kernels with ``nvcc`` and loads them with ``ctypes``.

Every ``*.cu`` under ``adell_mri_torch/csrc/`` is compiled for Hopper
(``sm_90a``) into one shared library with a plain C interface,
``build/adell_kernels/libadell_kernels.so`` at the repository root, at
first use. Sources compile in parallel (one ``nvcc`` each, with ``csrc/``
on the include path for its ``*.cuh`` headers) and link once. The library
is rebuilt whenever the content hash of the sources and headers changes.
A failed build raises with the compiler's output; nothing falls back.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "adell_kernels"
LIB_NAME = "libadell_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_lock = threading.Lock()
_lib = None
#: what the last build in this process did: seconds and nvcc's output
build_info = {"seconds": None, "log": ""}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _headers():
    return sorted(CSRC_DIR.glob("*.cuh"))


def _source_hash(sources, headers=()) -> str:
    """Hash of everything a build reads: sources, the headers they may
    include, and the flags."""
    h = hashlib.sha256()
    for path in (*sources, *headers):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels are built from source at first use"
    )


def _compile(nvcc: str, sources, out_path: Path) -> str:
    """Compiles each source to an object in parallel, then links."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", str(src),
                   "-o", str(obj)]
            procs.append(
                (src, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                ))
            )
        log, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed for {failed}:\n" + "\n".join(log)
            )
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", *(str(o) for _, o, _ in procs),
             "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        # atomic replace: a concurrent loader sees the old or the new file
        os.replace(tmp_lib, out_path)
    return "\n".join(log)


_SIGNATURES = {
    # x, w, bias, out, B, D, H, W, Cin, Cout, stream
    "adell_conv3d_igemm": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    ),
    # x, w, bias, out, B, D, H, W, Cin, Cout, stream
    "adell_conv3d_narrow": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    ),
    # Cin, Cout, out[6]: box z, y, x; channels a thread; slices; vector
    "adell_conv3d_narrow_plan": (
        [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    ),
    # x, out, par, seed, B, n, noise, rician, n_sm, stream
    "adell_intensity_aug": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    ),
    # q, k, v, out, m, l, image (f32: the workspace; bf16: null), BH, Nq,
    # Nkv, D, scale, stream
    "adell_flash_fwd": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p]
    ),
    # q, k, v, dout, lse, delta, dq, image (f32: the workspace; bf16:
    # null), BH, Nq, Nkv, D, scale, stream
    "adell_flash_bwd_dq": (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p]
    ),
    # q, k, v, dout, lse, delta, dk, dv, image, BH, Nq, Nkv, D, scale, stream
    "adell_flash_bwd_dkv": (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p]
    ),
    # kind (0 fwd, 1 dq, 2 dkv), D, out[5]: rows a block, threads, smem
    # bytes, rows of a streamed tile, bytes of its image (0: none)
    "adell_flash_plan": (
        [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    ),
}


# entry points of one name (no f32 twin)
_SINGLE = {
    # x, w, bias, out, B, D, H, W, Cin, Cout, tz, ty, tx, stream
    "adell_conv3d_wgmma_bf16": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    ),
    # Cin, Cout, out[2]: voxels a box, most halo rows
    "adell_conv3d_wgmma_limits": (
        [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    ),
    # x, w (TF32 big and small, [2, 27, Cout_pad, Cin]), bias, out, B, D,
    # H, W, Cin, Cout, tz, ty, tx, stream
    "adell_conv3d_wgmma_tf32x3": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    ),
    # Cin, Cout, out[3]: voxels a box, most halo rows, Cout_pad
    "adell_conv3d_wgmma_tf32x3_limits": (
        [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    ),
    # x, g, workspace, dW, B, D, H, W, Cin, Cout, tz, ty, tx, SMs, stream
    "adell_conv3d_wgrad_bf16": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    ),
    # Cin, Cout, out[2]: voxels a box, most halo rows
    "adell_conv3d_wgrad_limits": (
        [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    ),
    # B, D, H, W, Cin, Cout, tz, ty, tx, SMs, out[13]: the decomposition
    # (WgradPlan)
    "adell_conv3d_wgrad_plan": (
        [ctypes.c_int] * 10 + [ctypes.POINTER(ctypes.c_int)]
    ),
    # kind (0 and 2: K, V; 1: Q, dO, lse, delta), a, b, lse, delta, image,
    # BH, n, D, stream: the 3xTF32 kernels' preparation alone
    "adell_flash_image_f32": (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_void_p]
    ),
}


def _bind(lib):
    for stem, sig in _SIGNATURES.items():
        for suffix in ("_bf16", "_f32"):
            fn = getattr(lib, stem + suffix)
            fn.argtypes = sig
            fn.restype = ctypes.c_int
    for name, sig in _SINGLE.items():
        fn = getattr(lib, name)
        fn.argtypes = sig
        fn.restype = ctypes.c_int
    return lib


def load_library():
    """Returns the loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        if not sources:
            raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / LIB_NAME
        stamp = BUILD_DIR / "sources.sha256"
        digest = _source_hash(sources, _headers())
        fresh = (
            lib_path.exists()
            and stamp.exists()
            and stamp.read_text().strip() == digest
        )
        if not fresh:
            t0 = time.perf_counter()
            log = _compile(find_nvcc(), sources, lib_path)
            stamp.write_text(digest + "\n")
            (BUILD_DIR / "build.log").write_text(log)
            build_info.update(seconds=time.perf_counter() - t0, log=log)
        _lib = _bind(ctypes.CDLL(str(lib_path)))
        return _lib
