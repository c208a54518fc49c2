"""Build the port's CUDA kernels and load them through ``ctypes``.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` (all
started together), then linked into one shared library with a plain C
interface.  The library lands in ``build/repro_torch/`` at the root of
the checkout, named by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads the existing file.  Nothing
here runs at import: the first kernel launch calls
:func:`load_library`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DTYPE_CODES = {"float32": 0, "bfloat16": 1}   # csrc/common.cuh ReproDtype

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # g, mu, nu, w, scalars [lr, bc1, bc2], n, b1, 1 - b1, b2, 1 - b2, eps,
    # wd, g dtype, stream
    "fused_adamw_launch": [_P, _P, _P, _P, _P, _L, _F, _F, _F, _F, _F, _F,
                           _I, _P],
    # x, scale, y, rows, d, eps, dtype, stream
    "rmsnorm_rows_launch": [_P, _P, _P, _I, _I, _F, _I, _P],
    # x, ss (fp32 [rows]), rows, d, dtype, stream
    "rmsnorm_sumsq_launch": [_P, _P, _I, _I, _I, _P],
    # x, ss, scale, y, rows, d, d_full, eps, dtype, stream
    "rmsnorm_scale_launch": [_P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    # q, k, v, o, lse, B, Sq, Sk, H, G, D, scale, causal, window, prefix,
    # q_offset, dtype, stream
    "flash_attention_fwd_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _I, _F, _I, _I, _I, _I, _I, _P],
    # B, Sq, H, dtype -> warps per CTA of the flash kernel (0: fp32 kernel)
    "flash_attention_fwd_warps": [_I, _I, _I, _I],
    # x, B, C, dt, A, h0 (or NULL), y, h, batch, S, H, P, N, Q, stream
    "ssd_scan_f32_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _P],
    # x, B, C, dt, A, h0 (or NULL), y, h, states, cum, batch, S, H, P, N,
    # Q, stream
    "ssd_scan_bf16_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of the last build


def find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.access(default, os.X_OK) else None


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernels unless the library for these exact
    sources exists.  Raises when ``nvcc`` is missing or fails."""
    global build_seconds
    out = _library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                               str(obj)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    log_path = BUILD_DIR / "build.log"
    log_path.write_text("\n".join(logs))
    failed = [s.name for s, p in zip(sources, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}; see {log_path}:\n"
                           + "\n".join(logs)[-4000:])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stderr[-4000:]}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
