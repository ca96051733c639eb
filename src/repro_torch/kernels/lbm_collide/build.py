"""Build and load the hand-written CUDA stream+collide kernels.

``nvcc`` compiles ``csrc/lbm_collide.cu`` for ``sm_90a`` into shared
libraries with a plain C interface, at first use, into ``_build/`` beside
the sources (a directory git ignores): one library a part, a (dtype, Q)
pair (:data:`PARTS`), each compiled by its own ``nvcc`` with the part's
macros, all parts asked for at once compiled together. A library's name
carries a hash of the source, the flags and its part, so an edited source
is rebuilt and a current one is loaded as it is. Nothing is built when the
module is imported: the CPU tests import it on machines without a
compiler.
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

__all__ = ["build", "load_library", "NVCC_FLAGS", "PARTS"]

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "lbm_collide.cu"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# (dtype code: 0 float32, 1 float64; Q): the parts, one library each
PARTS = ((0, 19), (0, 27), (1, 19), (1, 27))

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    # dtype, Q, trt, f, mask, out, slots, nblocks, B, X, Y, Z, om_a, om_b,
    # lid, stream
    "lbm_stream_collide": (
        _I, _I, _I, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _I, _I, _I, _D, _D, _P, _P,
    ),
    # dtype, Q, trt, f, mask, out, coef, M, B, X, Y, Z, stream
    "lbm_stream_collide_members": (
        _I, _I, _I, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, _I, _I, _I, _P,
    ),
    # dtype, Q, trt, f, mask, out, slots, S, coef, M, B, X, Y, Z, om_a, om_b,
    # lid, map, nseg, seg_src, seg_mstride, seg_qstride, stream
    "lbm_stream_collide_halo_map": (
        _I, _I, _I, _P, _P, _P, _P, ctypes.c_longlong, _P, ctypes.c_longlong, ctypes.c_longlong, _I, _I, _I,
        _D, _D, _P, _P, _I, _P, _P, _P, _P,
    ),
    # dtype, Q, kind, dst, src, rows, n, dst_slot, dst_cell, src_slot,
    # src_cell, valid, members, dst_mstride, src_mstride, stream
    "lbm_halo_fill": (
        _I, _I, _I, _P, _P, ctypes.c_longlong, _I, _P, _P, _P, _P, _P,
        _I, ctypes.c_longlong, ctypes.c_longlong, _P,
    ),
    # which, dtype, Q, variant, out (int[5])
    "lbm_kernel_attrs": (_I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build the CUDA kernels")


def _part_flags(part: tuple[int, int]) -> tuple[str, ...]:
    return (f"-DLBM_PART_DTYPE={part[0]}", f"-DLBM_PART_Q={part[1]}")


def _library_path(part: tuple[int, int]) -> Path:
    flags = " ".join((*NVCC_FLAGS, *_part_flags(part)))
    digest = hashlib.sha256(SOURCE.read_bytes() + flags.encode())
    return BUILD_DIR / f"liblbm_collide_{('f32', 'f64')[part[0]]}_q{part[1]}_{digest.hexdigest()[:16]}.so"


def build(parts=PARTS) -> tuple[list[Path], str]:
    """Compile the library of each part in ``parts`` unless a current one
    exists, one ``nvcc`` a part, all started together.

    Returns the libraries' paths and the compilers' output (``-Xptxas -v``
    register and spill counts; empty when nothing was compiled)."""
    paths = [_library_path(tuple(part)) for part in parts]
    todo = [(part, lib) for part, lib in zip(parts, paths) if not lib.exists()]
    if not todo:
        return paths, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to private names, then rename: concurrent builders never see
    # a half-written library
    jobs = []
    try:
        for part, lib in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, *_part_flags(part), "-o", tmp, str(SOURCE)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs.append((proc, tmp, lib))
        logs = []
        for proc, tmp, lib in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) for {lib.name}:\n{out}")
            os.replace(tmp, lib)
            logs.append(out)
    finally:
        for proc, tmp, _lib in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return paths, "".join(logs)


@functools.cache
def load_library(dtype_code: int, Q: int) -> ctypes.CDLL:
    """Build the part of ``(dtype_code, Q)`` if needed, load it once per
    process, and declare the C signatures."""
    if (dtype_code, Q) not in PARTS:
        raise ValueError(f"no kernel part for dtype code {dtype_code} and Q = {Q}")
    (path,), _log = build([(dtype_code, Q)])
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
