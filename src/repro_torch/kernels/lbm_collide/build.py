"""Build and load the hand-written CUDA stream+collide kernels.

``nvcc`` compiles ``csrc/lbm_collide.cu`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``_build/`` beside the
sources (a directory git ignores). The library's name carries a hash of the
source and flags, so an edited source is rebuilt and a current one is
loaded as it is. Nothing is built when the module is imported: the CPU
tests import it on machines without a compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["build", "load_library", "NVCC_FLAGS"]

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "lbm_collide.cu"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    # dtype, Q, trt, f, mask, out, B, X, Y, Z, om_a, om_b, lid, stream
    "lbm_stream_collide": (
        _I, _I, _I, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _D, _D, _P, _P,
    ),
    # dtype, Q, trt, f, mask, halo_vals, halo_cell, halo_valid, P, out,
    # B, X, Y, Z, om_a, om_b, lid, stream
    "lbm_stream_collide_halo": (
        _I, _I, _I, _P, _P, _P, _P, _P, _I, _P,
        ctypes.c_longlong, _I, _I, _I, _D, _D, _P, _P,
    ),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build the CUDA kernels")


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"liblbm_collide_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the library unless a current one exists.

    Returns the library's path and the compiler's output (``-Xptxas -v``
    register and spill counts; empty when nothing was compiled)."""
    lib = _library_path()
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never see
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    path, _log = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
