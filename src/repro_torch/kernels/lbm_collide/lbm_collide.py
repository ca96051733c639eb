"""Hand-written CUDA stream+collide kernels for Hopper, and their wrappers.

Each wrapper launches its kernel from ``csrc/lbm_collide.cu`` for a CUDA
tensor and takes its plain PyTorch version (:mod:`.ref`) only when the
tensor lies on the CPU. A CUDA tensor whose kernel cannot be built or
launched raises; nothing falls back.

* :func:`lbm_stream_collide` replaces the JAX package's Pallas kernel
  ``lbm_stream_collide_pallas`` (``repro/kernels/lbm_collide/lbm_collide.py``,
  ``_kernel`` -> ``_stream_collide_body``). Bound: bytes. Per cell it must
  read Q pdfs and one int32 cell type and write Q pdfs; at about 4 flops per
  byte it is far below the card's flop-to-byte ratio. Design: one thread per
  cell over a 1-D grid of ``B*X*Y*Z`` with Z innermost (coalesced q-planes),
  neighbours pulled from global memory with the block-local wrap of
  ``jnp.roll``, moments summed in registers in the Pallas body's fixed q
  order, BGK or TRT with host-rounded coefficients as kernel arguments.
  The TPU kernel's whole-block-in-VMEM layout (3 MB a block) does not fit a
  CTA's 227 KB of shared memory and is not imitated.
* :func:`lbm_stream_collide_halo` replaces ``lbm_stream_collide_halo_pallas``
  (``_halo_kernel``). Bound: bytes, those of the stencil plus the padded
  ghost slab (``P*(Q*s + 5)`` bytes a block). Design: two launches on one
  stream, a fill kernel writing the slab's valid rows into the ghost ring of
  ``f`` *in place*, then the stencil. On the TPU one grid step owned a whole
  block; here a block spans many CTAs, so the launch boundary orders the
  fill before any neighbour read. The caller must treat ``f`` as consumed:
  the superstep that uses this gathers every fill value before any level
  steps, and fill targets are ghost cells while fill sources are interior
  cells, so the in-place write is never read by a later gather.

Both wrappers allocate their output with ``torch.empty``; the stencil pulls
from its input, so it cannot run in place. PyTorch's caching allocator hands
the buffer freed by the previous step to the next, which makes successive
steps a ping-pong between two buffers per level.

Launch counts: each wrapper carries a plain integer ``launches`` that it
bumps where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...lbm.lattice import D3Q19, Lattice
from .ref import _np_dtype, collision_coeffs, stream_collide_coeffs, stream_collide_halo_ref

__all__ = ["lbm_stream_collide", "lbm_stream_collide_halo"]

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def _kernel_args(
    dtype: torch.dtype,
    *,
    omega: float,
    lattice: Lattice,
    u_wall: tuple[float, float, float],
    collision: str,
    magic: float,
) -> tuple[dict, tuple[int, float, float], np.ndarray]:
    """Host coefficients for one dtype: the :func:`~.ref.collision_coeffs`
    dict (plain path) and the same values as the kernel's ``(trt, om_a,
    om_b)`` and float64 ``lid`` array. Rounded to ``dtype`` once, so holding
    them in float64 for the C call is exact."""
    coeffs = collision_coeffs(
        omega,
        lattice=lattice,
        u_wall=u_wall,
        collision=collision,
        magic=magic,
        dtype=_np_dtype(dtype),
    )
    if collision == "bgk":
        scal = (0, float(coeffs["om"]), 0.0)
    else:
        scal = (1, float(coeffs["om_p"]), float(coeffs["om_m"]))
    lid = np.ascontiguousarray(coeffs["lid"], dtype=np.float64)
    return coeffs, scal, lid


def _check(f: torch.Tensor, mask: torch.Tensor, lattice: Lattice) -> None:
    if f.dim() != 5 or f.shape[1] != lattice.Q:
        raise ValueError(f"f must be (B, {lattice.Q}, X, Y, Z), got {tuple(f.shape)}")
    if f.dtype not in _DTYPE_CODE:
        raise TypeError(f"f must be float32 or float64, got {f.dtype}")
    B, _Q, X, Y, Z = f.shape
    if tuple(mask.shape) != (B, X, Y, Z):
        raise ValueError(f"mask shape {tuple(mask.shape)} != {(B, X, Y, Z)}")
    if mask.dtype != torch.int32:
        raise TypeError(f"mask must be int32, got {mask.dtype}")
    if mask.device != f.device:
        raise ValueError(f"mask on {mask.device}, f on {f.device}")
    if X * Y * Z >= 2**31:
        raise ValueError("one block's cell count must fit 32 bits")
    if f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {f.device}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def lbm_stream_collide(
    f: torch.Tensor,
    mask: torch.Tensor,
    *,
    omega: float,
    lattice: Lattice = D3Q19,
    u_wall: tuple[float, float, float] = (0.0, 0.0, 0.0),
    collision: str = "bgk",
    magic: float = 3.0 / 16.0,
) -> torch.Tensor:
    """Fused stream+collide over a stack of blocks.

    Args:
      f:    (B, Q, X, Y, Z) post-collision PDFs (ghost layer included).
      mask: (B, X, Y, Z) int32 cell types (0 fluid / 1 wall / 2 lid).
    Returns:
      (B, Q, X, Y, Z) updated PDFs, a new tensor.
    """
    _check(f, mask, lattice)
    coeffs, (trt, om_a, om_b), lid = _kernel_args(
        f.dtype, omega=omega, lattice=lattice, u_wall=u_wall,
        collision=collision, magic=magic,
    )
    if f.device.type == "cpu":
        return stream_collide_coeffs(f, mask, coeffs, lattice=lattice, collision=collision)
    if not (f.is_contiguous() and mask.is_contiguous()):
        raise ValueError("f and mask must be contiguous")
    from .build import load_library

    lib = load_library()
    out = torch.empty(f.shape, dtype=f.dtype, device=f.device)
    B, Q, X, Y, Z = f.shape
    err = lib.lbm_stream_collide(
        _DTYPE_CODE[f.dtype], Q, trt, f.data_ptr(), mask.data_ptr(), out.data_ptr(),
        B, X, Y, Z, om_a, om_b, lid.ctypes.data_as(ctypes.c_void_p),
        _stream_ptr(f.device),
    )
    _raise_on(err, "lbm_stream_collide")
    lbm_stream_collide.launches += 1
    return out


lbm_stream_collide.launches = 0


def lbm_stream_collide_halo(
    f: torch.Tensor,
    mask: torch.Tensor,
    halo_vals: torch.Tensor,
    halo_cell: torch.Tensor,
    halo_valid: torch.Tensor,
    *,
    omega: float,
    lattice: Lattice = D3Q19,
    u_wall: tuple[float, float, float] = (0.0, 0.0, 0.0),
    collision: str = "bgk",
    magic: float = 3.0 / 16.0,
) -> torch.Tensor:
    """Ghost fill + fused stream+collide over a stack of blocks.

    Args:
      f:          (B, Q, X, Y, Z) post-collision PDFs. On a CUDA device the
                  fill is written into ``f``'s ghost ring in place.
      mask:       (B, X, Y, Z) int32 cell types.
      halo_vals:  (B, P, Q) padded per-block ghost values, ``f``'s dtype.
      halo_cell:  (B, P) int32 flat cell ids into the ghosted (X, Y, Z) box;
                  pad rows point at the block's centre cell.
      halo_valid: (B, P) bool; False rows are not written.
    Returns:
      (B, Q, X, Y, Z) updated PDFs, a new tensor.
    """
    _check(f, mask, lattice)
    B, Q, X, Y, Z = f.shape
    P = halo_cell.shape[1] if halo_cell.dim() == 2 else -1
    if tuple(halo_vals.shape) != (B, P, Q) or halo_vals.dtype != f.dtype:
        raise ValueError(f"halo_vals must be (B, P, Q) {f.dtype}, got {tuple(halo_vals.shape)} {halo_vals.dtype}")
    if tuple(halo_cell.shape) != (B, P) or halo_cell.dtype != torch.int32:
        raise ValueError(f"halo_cell must be (B, P) int32, got {tuple(halo_cell.shape)} {halo_cell.dtype}")
    if tuple(halo_valid.shape) != (B, P) or halo_valid.dtype != torch.bool:
        raise ValueError(f"halo_valid must be (B, P) bool, got {tuple(halo_valid.shape)} {halo_valid.dtype}")
    if any(t.device != f.device for t in (halo_vals, halo_cell, halo_valid)):
        raise ValueError("halo operands must lie on f's device")
    coeffs, (trt, om_a, om_b), lid = _kernel_args(
        f.dtype, omega=omega, lattice=lattice, u_wall=u_wall,
        collision=collision, magic=magic,
    )
    if f.device.type == "cpu":
        b_idx, p_idx = halo_valid.nonzero(as_tuple=True)
        return stream_collide_halo_ref(
            f, halo_vals[b_idx, p_idx], b_idx, halo_cell[b_idx, p_idx].long(), coeffs,
            mask=mask, lattice=lattice, collision=collision,
        )
    operands = (f, mask, halo_vals, halo_cell, halo_valid)
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("f, mask and the halo operands must be contiguous")
    from .build import load_library

    lib = load_library()
    out = torch.empty(f.shape, dtype=f.dtype, device=f.device)
    err = lib.lbm_stream_collide_halo(
        _DTYPE_CODE[f.dtype], Q, trt, f.data_ptr(), mask.data_ptr(),
        halo_vals.data_ptr(), halo_cell.data_ptr(), halo_valid.data_ptr(), P,
        out.data_ptr(), B, X, Y, Z, om_a, om_b,
        lid.ctypes.data_as(ctypes.c_void_p), _stream_ptr(f.device),
    )
    _raise_on(err, "lbm_stream_collide_halo")
    lbm_stream_collide_halo.launches += 1
    return out


lbm_stream_collide_halo.launches = 0
