"""Build the CUDA kernels under ``csrc/`` with nvcc and load them via ctypes.

All ``csrc/*.cu`` files compile into one shared library with a plain C
interface, at first use, into ``build/im23d_kernels/`` at the repository
root: one ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c`` per source,
all started together, then one link.  The file name carries a hash of the
sources, the ``csrc/*.cuh`` headers they share and the flags, so an edited
kernel or header is rebuilt and a current one is loaded as it is.  A failed
build raises.

Every C entry point takes device pointers and the CUDA stream as ``void*``
and returns the ``cudaError_t`` of its launches; ``check`` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "im23d_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)
_SIGNATURES = {
    # gz, gy, gx, c, taps, K, scale, out, B, N, S, eps, cluster, planes,
    # stage, smem, stream
    "im23d_projection_fwd": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _F,
                             _I, _I, _I, _L, _P],
    # gz, gy, gx, c, taps, K, scale, gsil, dscale, dgz, dgy, dgx, B, N, S,
    # eps, cluster, planes, stage, smem, stream
    "im23d_projection_bwd": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _F, _I, _I, _I, _L, _P],
    # dev, out
    "im23d_projection_limits": [_I, _P],
    # S, K, cluster, planes, stage, bwd, smem, out
    "im23d_projection_occupancy": [_I, _I, _I, _I, _I, _I, _L, _P],
    # x, y, rows, cols, B, N, M, ny, stream
    "im23d_chamfer": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # dev, out
    "im23d_chamfer_limits": [_I, _P],
    # fv, attrs, feat, soft, win, wz, recs, bins, B, F, A, H, W, tile_w,
    # tile_h, sx, sy, sigma, margin, cull, stream
    "im23d_rasterize_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _F, _F, _F, _F, _I, _P],
    # fv, attrs, dfeat, dsoft, soft, win, wz, dfv, dattrs, B, F, A, H, W,
    # sx, sy, sigma, margin, cull, stream
    "im23d_rasterize_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                            _I, _I, _F, _F, _F, _F, _I, _P],
    # img, grid, out, B, H, W, C, P, stream
    "im23d_grid_sample_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # img, grid, dout, dimg, dgrid, B, H, W, C, P, runs, stream
    "im23d_grid_sample_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _P],
    # out
    "im23d_k5b_limits": [_P],
    # x, w, bias, y, B, C, H, W, circular, stream (float32 x; bfloat16 x)
    "im23d_head_conv_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "im23d_head_conv_fwd_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, g, partial, dw, B, C, H, W, circular, bf16, nrows, stream
    "im23d_head_conv_dw": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, a, b, w, w9, y, B, Cin, Cout, H, W, circular, affine, bf16, ti,
    # th, tw, vec, resident, bw, bh, stream
    "im23d_fused_conv_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # gz, gy, gx, c, out, B, N, S, cluster, smem, stream
    "im23d_splat_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _P],
    # dev, out
    "im23d_splat_limits": [_I, _P],
    # gz, gy, gx, c, g, dgz, dgy, dgx, dc, B, N, S, planes, rows, stride,
    # smem, stream
    "im23d_splat_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _L, _P],
    # gz, gy, gx, c, taps, K, out, B, N, S, planes, stride, smem, stream
    "im23d_splat_blur_fwd": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                             _L, _P],
    # dev, out
    "im23d_splat_blur_limits": [_I, _P],
    # gz, gy, gx, c, taps, K, g, dgz, dgy, dgx, dc, B, N, S, planes, rows,
    # stride, smem, stream
    "im23d_splat_blur_bwd": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I,
                             _I, _I, _I, _I, _I, _L, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build in this process did: seconds, library path, ptxas log
build_info: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); set CUDA_HOME")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _library_path(sources: list[Path]) -> Path:
    """The library's file name, from a hash of the flags, the sources and
    the headers they include (``csrc/*.cuh``)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libim23d_kernels_{h.hexdigest()[:16]}.so"


def _build() -> ctypes.CDLL:
    sources = sorted(CSRC.glob("*.cu"))
    lib_path = _library_path(sources)
    t0 = time.perf_counter()
    log = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{lib_path.stem}.{os.getpid()}"
        nvcc = _nvcc()
        objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        failed = [(src.name, p.returncode, out) for src, p, out
                  in zip(sources, procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{out}" for name, rc, out in failed))
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        for obj in objs:
            obj.unlink()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
        lib_path.with_suffix(".log").write_text(log)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.im23d_fused_conv_limits.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.im23d_fused_conv_limits.restype = ctypes.c_int
    lib.im23d_error_string.argtypes = [ctypes.c_int]
    lib.im23d_error_string.restype = ctypes.c_char_p
    build_info.update(seconds=time.perf_counter() - t0, path=str(lib_path),
                      ptxas=log)
    return lib


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first call in this process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.im23d_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
