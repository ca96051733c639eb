"""Hand-written CUDA stream+collide and ghost-fill kernels for Hopper, and
their wrappers.

Each wrapper launches its kernel from ``csrc/lbm_collide.cu`` for a CUDA
tensor and takes its plain PyTorch version (:mod:`.ref`) only when the
tensor lies on the CPU. A CUDA tensor whose kernel cannot be built or
launched raises; nothing falls back.

* :func:`lbm_stream_collide` replaces the JAX package's Pallas kernel
  ``lbm_stream_collide_pallas`` (``repro/kernels/lbm_collide/lbm_collide.py``,
  ``_kernel`` -> ``_stream_collide_body``). Bound: bytes. Per cell it must
  read Q pdfs and one int32 cell type and write Q pdfs; at about 4 flops per
  byte it is far below the card's flop-to-byte ratio. Design: one CTA per
  (z/y tile of an x-plane, x, block) with z innermost (coalesced q-planes);
  each thread issues its Q pulled pdf loads (the block-local wrap keeps
  them in bounds) without condition, together with the loads of the CTA's
  wrapped mask tile, which it stages in shared memory as bytes; where a
  source is not fluid it then loads the bounce-back value. No pdf load
  waits on another global load, and 64 registers keep 50 % occupancy.
  Moments summed in registers in the Pallas body's fixed q order; BGK or
  TRT with host-rounded coefficients as kernel arguments. The TPU kernel's whole-block-in-VMEM layout (3 MB a
  block) does not fit a CTA's 227 KB of shared memory and is not imitated.
  With ``slots`` it steps only the listed blocks of the stack into a given
  ``out`` (grid z indexes the list): the rank-sharded engine's interior and
  boundary halves write one output tensor this way, gathering no sub-stack.
  With ``members`` (:class:`MemberCoeffs`) it steps an ensemble's member
  stack ``(M, B, Q, X, Y, Z)`` over one shared mask stack in one launch,
  each member with its own coefficients from a device table that each CTA
  stages in shared memory: the counterpart of the JAX ensemble's ``vmap``,
  so a batch of M members launches what one member's step launches.
* :func:`lbm_halo_fill` is the separate ghost fill: one segment of a
  level's merged fill, read straight from the source level's buffer
  (``same``/``coarse``: one cell; ``fine``: the mean of an octet) and
  written into the destination's ghost ring in place. Bound: bytes, each
  row's source values, its Q written values and its int32 indices. Rows
  are sorted by (dst slot, dst cell), one thread a row, so for each q a
  warp touches neighbouring cells of one q-plane. Its ``"values"`` kind
  writes the rows of an (N, Q) array instead (the slab interface below).
  Given member stacks ``(M, B, Q, X, Y, Z)`` it fills the segment of all M
  members in one launch (grid y is the member), through one set of index
  tables. No engine path launches it: the rank absorb without a halo
  stepper factory (the yardstick of the halo route there) does.
* The halo route of :func:`lbm_stream_collide` (``halo`` and ``sources``)
  replaces ``lbm_stream_collide_halo_pallas`` (``_halo_kernel``) on the
  fused, serving and rank paths: one launch a filled level, the stencil
  reading each ghost value it pulls from that value's source (halo in
  tile) through the level's :class:`HaloMap`, bitwise the fill then the
  stencil. A source is a pre-step stack, or on a rank path a received
  ``(N, Q)`` halo payload (a ``"values"`` segment: its rows are read
  where the stencil pulls them, and no ghost cell is written). Bound:
  bytes, the halo step's (the stencil's, less the ghost rows it need not
  read, plus the other levels' source cells and the payload rows). A
  separate fill pays a 32-byte sector a value for the z-face rows, whose
  cells and sources lie alone in their sectors, and writes them back; the
  route writes no ghost cell, and its grid runs 8 blocks' CTAs of one x
  plane together, so that a z-face source row, which its neighbour's CTA
  reads whole, is an L2 hit. It works solo, over a slot list (a rank's
  interior and boundary halves) and over a member axis.
* :func:`lbm_stream_collide_halo` replaces ``lbm_stream_collide_halo_pallas``
  at its interface: the padded (B, P, Q) ghost slab. Its CUDA path is the
  fill kernel reading the slab's valid rows, then the stencil, two launches
  on one stream: on the TPU one grid step owned a whole block; here a block
  spans many CTAs, so the launch boundary orders the fill before any
  neighbour read. The caller must treat ``f`` as consumed. No path builds
  the slab.

The stencil wrappers allocate their output with ``torch.empty``; the
stencil pulls from its input, so it cannot run in place. PyTorch's caching
allocator hands the buffer freed by the previous step to the next, which
makes successive steps a ping-pong between two buffers per level.

Launch counts: each wrapper carries a plain integer ``launches`` that it
bumps where it launches its kernel, and nowhere else; beside it,
``lbm_stream_collide.slot_launches`` counts the launches over a slot list,
``lbm_stream_collide.member_launches`` those over a member axis,
``lbm_stream_collide.halo_launches`` those of the halo route (solo, over a
slot list and over members), ``lbm_stream_collide.halo_slot_launches`` and
``lbm_stream_collide.halo_member_launches`` those of them over a slot list
and over a member axis, and
``lbm_halo_fill.kind_launches`` the fill launches by kind (``copy`` for
``same``/``coarse``, ``fine``, ``values``; ``copy+members`` and
``fine+members`` over a member axis). :func:`reset_launches` zeroes them
all.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence
from dataclasses import dataclass

import numpy as np
import torch

from ...lbm.lattice import D3Q19, Lattice
from .ref import (
    _np_dtype,
    collision_coeffs,
    halo_fill_ref,
    halo_stream_collide_ref,
    stack_coeffs,
    stream_collide_halo_ref,
    stream_collide_into,
)

__all__ = [
    "lbm_stream_collide",
    "lbm_stream_collide_halo",
    "lbm_halo_fill",
    "HaloMap",
    "MemberCoeffs",
    "member_coeffs",
    "kernel_attributes",
    "reset_launches",
]

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_FILL_VALUES = 2
FILL_KINDS = {"same": 0, "coarse": 0, "fine": 1, "values": _FILL_VALUES}
_KIND_NAMES = ("copy", "fine", "values")  # by kernel code
_MEMBER_KIND_NAMES = ("copy+members", "fine+members")  # by kernel code


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


@dataclass(frozen=True)
class MemberCoeffs:
    """The collision coefficients of an ensemble's M members at one level,
    for the member axis of :func:`lbm_stream_collide`. ``host`` is the
    :func:`~.ref.stack_coeffs` dict the plain version takes (``lid``
    ``(M, Q)``, each rate ``(M,)``); ``table`` holds the same values as the
    kernel's ``(M, Q + 2)`` device table (``lid[Q]``, ``om_a``, ``om_b``)
    in the field's dtype. Built by :func:`member_coeffs`."""

    lattice: Lattice
    collision: str
    host: dict
    table: torch.Tensor

    @property
    def size(self) -> int:
        return self.table.shape[0]


def member_coeffs(
    omegas,
    u_walls,
    *,
    lattice: Lattice = D3Q19,
    collision: str = "bgk",
    magic: float = 3.0 / 16.0,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> MemberCoeffs:
    """Each member's coefficients from :func:`~.ref.collision_coeffs`,
    rounded to ``dtype`` exactly as a solo launch's are (:func:`_kernel_args`),
    stacked over members for both paths."""
    per, rows = [], []
    for omega, u_wall in zip(omegas, u_walls, strict=True):
        coeffs, (_trt, om_a, om_b), lid = _kernel_args(
            dtype, omega=omega, lattice=lattice, u_wall=u_wall, collision=collision, magic=magic,
        )
        per.append(coeffs)
        rows.append(np.concatenate([lid, [om_a, om_b]]))
    # float64 rows of values already rounded to dtype: the cast is exact
    table = torch.as_tensor(np.stack(rows), dtype=dtype, device=device)
    return MemberCoeffs(lattice, collision, stack_coeffs(per), table)


# a row's source: segment << 58 | fine << 57 | stage << 56 | element offset
HALO_SEG_SHIFT = 58
HALO_FINE_BIT = 57
HALO_STAGE_BIT = 56
# a level's local kinds (same, coarse, fine) and one segment for each payload
# that reaches a rank's level; the segment field's 5 bits bound it
HALO_MAX_SEGMENTS = 32
# the route's grid runs the CTAs of this many consecutive blocks (or slot-list
# entries) at one x plane together: the source's kHaloGroup
HALO_GROUP = 8


@dataclass(frozen=True)
class HaloMap:
    """One level's ghost fill as the halo route of :func:`lbm_stream_collide`
    reads it, built once per superstep build by :func:`~.ops.halo_map`.

    ``cells`` is a (B, X, Y, Z) int64 map over the level's blocks: where a
    cell has a fill row, ``k << HALO_SEG_SHIFT | fine << HALO_FINE_BIT |
    stage << HALO_STAGE_BIT | o``, with ``o`` the element offset of the
    row's source cell (direction 0) in the stack of ``tables[k]``, ``fine``
    1 for a ``fine`` row, whose octet starts there, in the canonical order,
    and ``stage`` 1 for a ``fine`` row whose cell reads its own values
    under ``mask`` (it or a neighbour is not fluid); -1 everywhere else.
    A ``"values"`` table's source is an ``(N, Q)`` payload: ``o`` is its
    row times Q, and a row's directions are adjacent.
    ``tables`` are the level's :class:`~.ops.FillTable` segments, at most
    :data:`HALO_MAX_SEGMENTS`: ``src`` (the source's position in the
    route's ``sources``) and ``kind``, and the index tensors that the plain
    version reads. ``mask`` is the cell-type stack the map was built from;
    the route takes only that one."""

    cells: torch.Tensor
    tables: tuple
    mask: torch.Tensor


def _check_block_stack(f: torch.Tensor, Q: int) -> None:
    if f.dim() != 5 or f.shape[1] != Q:
        raise ValueError(f"a block stack must be (B, {Q}, X, Y, Z), got {tuple(f.shape)}")
    if f.dtype not in _DTYPE_CODE:
        raise TypeError(f"a block stack must be float32 or float64, got {f.dtype}")
    if Q * f.shape[2] * f.shape[3] * f.shape[4] >= 2**31:
        raise ValueError("one block's Q * cells must fit 31 bits")
    if f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {f.device}")


def _check(f: torch.Tensor, mask: torch.Tensor, lattice: Lattice) -> None:
    _check_block_stack(f, lattice.Q)
    B, _Q, X, Y, Z = f.shape
    if tuple(mask.shape) != (B, X, Y, Z):
        raise ValueError(f"mask shape {tuple(mask.shape)} != {(B, X, Y, Z)}")
    if mask.dtype != torch.int32:
        raise TypeError(f"mask must be int32, got {mask.dtype}")
    if mask.device != f.device:
        raise ValueError(f"mask on {mask.device}, f on {f.device}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _stream_ptr(device: torch.device) -> int:
    """The current stream of ``device``. Every launch runs inside
    ``torch.cuda.device(device)``, so the library launches into that card's
    context, whichever card the process made current: a rank's tensors may
    lie on another card than ``cuda:0``."""
    return torch.cuda.current_stream(device).cuda_stream


def _library(dtype: torch.dtype, Q: int):
    """The built kernels of ``dtype`` and ``Q`` (one library a pair)."""
    from .build import load_library

    return load_library(_DTYPE_CODE[dtype], Q)


def _check_card_operands(*tensors: torch.Tensor) -> None:
    """What the CUDA path needs beyond ``_check``: contiguous operands, and
    block extents of at least 2 (the stencil keeps one wrap correction an
    axis, which needs the low and the high edge to be distinct cells)."""
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel's operands must be contiguous")
    if min(tensors[0].shape[2:]) < 2:
        raise ValueError(f"the CUDA stencil needs every block extent >= 2, got {tuple(tensors[0].shape[2:])}")


def _launch_stencil(lib, f, mask, out, trt, om_a, om_b, lid, slots=None) -> None:
    B, Q, X, Y, Z = f.shape
    with torch.cuda.device(f.device):
        err = lib.lbm_stream_collide(
            _DTYPE_CODE[f.dtype], Q, trt, f.data_ptr(), mask.data_ptr(), out.data_ptr(),
            None if slots is None else slots.data_ptr(), B, B if slots is None else slots.numel(),
            X, Y, Z, om_a, om_b, lid.ctypes.data_as(ctypes.c_void_p), _stream_ptr(f.device),
        )
    _raise_on(err, "lbm_stream_collide")


def lbm_stream_collide(
    f: torch.Tensor,
    mask: torch.Tensor,
    *,
    omega: float | None = None,
    lattice: Lattice = D3Q19,
    u_wall: tuple[float, float, float] = (0.0, 0.0, 0.0),
    collision: str = "bgk",
    magic: float = 3.0 / 16.0,
    slots: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
    members: MemberCoeffs | None = None,
    halo: HaloMap | None = None,
    sources: Sequence[torch.Tensor] | None = None,
) -> torch.Tensor:
    """Fused stream+collide over a stack of blocks, or over the member
    stacks of an ensemble, optionally with the ghost ring read through a
    halo map (halo in tile).

    Args:
      f:       (B, Q, X, Y, Z) post-collision PDFs (ghost layer included);
               with ``members``, (M, B, Q, X, Y, Z): M members' stacks.
      mask:    (B, X, Y, Z) int32 cell types (0 fluid / 1 wall / 2 lid),
               shared by every member.
      omega:   relaxation rate of a solo stack (with ``u_wall``,
               ``collision``, ``magic`` and ``lattice``); not given with
               ``members``, which carry each member's coefficients.
      slots:   optional (S,) int32 block indices on ``f``'s device, each in
               [0, B): step only those blocks (the caller builds the list on
               the host and checks its range; the kernel steps nothing for
               an index outside it). Blocks not listed are left as ``out``
               has them. Not with ``members``. With ``halo``, only the
               listed blocks' map entries are read, so their rows alone
               must name ``halo.tables``.
      out:     optional output shaped like ``f``, ``f``'s dtype and device;
               it must not be ``f`` (the stencil pulls from its input), and
               on the halo route it must not overlap ``f`` or a source.
      members: optional :class:`MemberCoeffs` of the M members, its table
               on ``f``'s device in ``f``'s dtype.
      halo:    optional :class:`HaloMap` of ``f``'s level, with ``sources``:
               the step then computes the stencil of ``f`` with every cell
               that has a fill row holding its filled value, read from the
               row's source (one cell, or an octet's mean) instead of from
               ``f``. ``f`` and the sources are only read.
      sources: what the halo map's tables index: the pre-step stacks (the
               superstep's buffer tuple, ``f`` among them), each ``f``'s
               dtype, device and block shape, member stacks with
               ``members``; on a rank path then the received ``(N, Q)``
               payloads of its ``"values"`` tables (contiguous, solo only).
    Returns:
      ``out``, or a new tensor when it is not given.
    """
    if (halo is None) != (sources is None):
        raise ValueError("a halo map and its sources come together")
    if halo is not None:
        if members is not None and (omega is not None or slots is not None):
            raise ValueError("a member stack takes its coefficients from members, and no slot list")
        if members is None and omega is None:
            raise TypeError("the halo route needs omega, or members for a member stack")
        kw = dict(omega=omega, lattice=lattice, u_wall=u_wall, collision=collision, magic=magic)
        return _stream_collide_halo(f, mask, halo, tuple(sources), out, members, slots, kw)
    if members is not None:
        if omega is not None or slots is not None:
            raise ValueError("a member stack takes its coefficients from members, and no slot list")
        return _stream_collide_members(f, mask, members, out)
    if omega is None:
        raise TypeError("lbm_stream_collide needs omega, or members for a member stack")
    _check(f, mask, lattice)
    _check_slots(f, slots)
    _check_out(f, out)
    coeffs, (trt, om_a, om_b), lid = _kernel_args(
        f.dtype, omega=omega, lattice=lattice, u_wall=u_wall,
        collision=collision, magic=magic,
    )
    if f.device.type == "cpu":
        return stream_collide_into(f, mask, coeffs, lattice=lattice, collision=collision, slots=slots, out=out)
    _check_card_operands(f, mask, *(t for t in (slots, out) if t is not None))
    lib = _library(f.dtype, lattice.Q)
    if out is None:
        out = torch.empty(f.shape, dtype=f.dtype, device=f.device)
    _launch_stencil(lib, f, mask, out, trt, om_a, om_b, lid, slots)
    lbm_stream_collide.launches += 1
    if slots is not None:
        lbm_stream_collide.slot_launches += 1
    return out


def _check_slots(f: torch.Tensor, slots: torch.Tensor | None) -> None:
    if slots is not None and (slots.dim() != 1 or slots.dtype != torch.int32 or slots.device != f.device):
        raise ValueError(f"slots must be (S,) int32 on {f.device}, got {tuple(slots.shape)} {slots.dtype} {slots.device}")


def _check_out(f: torch.Tensor, out: torch.Tensor | None) -> None:
    if out is not None:
        if out.shape != f.shape or out.dtype != f.dtype or out.device != f.device:
            raise ValueError(f"out must be {tuple(f.shape)} {f.dtype} on {f.device}")
        if out.data_ptr() == f.data_ptr():
            raise ValueError("out must not be f: the stencil pulls from its input")


def _check_members(f: torch.Tensor, mask: torch.Tensor, members: MemberCoeffs) -> None:
    lattice = members.lattice
    if f.dim() != 6 or f.shape[0] != members.size:
        raise ValueError(f"a member stack must be ({members.size}, B, {lattice.Q}, X, Y, Z), got {tuple(f.shape)}")
    _check(f[0], mask, lattice)
    table = members.table
    M = f.shape[0]
    if tuple(table.shape) != (M, lattice.Q + 2) or table.dtype != f.dtype or table.device != f.device:
        raise ValueError(f"the member table must be ({M}, {lattice.Q + 2}) {f.dtype} on {f.device}, "
                         f"got {tuple(table.shape)} {table.dtype} {table.device}")


def _stream_collide_members(
    f: torch.Tensor, mask: torch.Tensor, members: MemberCoeffs, out: torch.Tensor | None
) -> torch.Tensor:
    """The member route of :func:`lbm_stream_collide`."""
    lattice = members.lattice
    _check_members(f, mask, members)
    M, B = f.shape[:2]
    table = members.table
    _check_out(f, out)
    if f.device.type == "cpu":
        return stream_collide_into(f, mask, members.host, lattice=lattice, collision=members.collision, out=out)
    _check_card_operands(f[0], f, mask, table, *(t for t in (out,) if t is not None))
    lib = _library(f.dtype, lattice.Q)
    if out is None:
        out = torch.empty(f.shape, dtype=f.dtype, device=f.device)
    _Q, X, Y, Z = f.shape[2:]
    with torch.cuda.device(f.device):
        err = lib.lbm_stream_collide_members(
            _DTYPE_CODE[f.dtype], lattice.Q, int(members.collision == "trt"), f.data_ptr(), mask.data_ptr(),
            out.data_ptr(), table.data_ptr(), M, B, X, Y, Z, _stream_ptr(f.device),
        )
    _raise_on(err, "lbm_stream_collide (members)")
    lbm_stream_collide.launches += 1
    lbm_stream_collide.member_launches += 1
    return out


def _span(t: torch.Tensor) -> tuple[int, int]:
    """The bytes ``[first, end)`` that ``t``'s elements lie within."""
    if t.numel() == 0:
        return 0, 0
    last = sum((size - 1) * stride for size, stride in zip(t.shape, t.stride()))
    return t.data_ptr(), t.data_ptr() + (last + 1) * t.element_size()


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    (a0, a1), (b0, b1) = _span(a), _span(b)
    return a.device == b.device and a0 < b1 and b0 < a1


def _check_halo(f: torch.Tensor, mask: torch.Tensor, halo: HaloMap, sources: tuple, lead: int) -> None:
    """The halo route's operands beyond the stencil's."""
    cells = halo.cells
    if tuple(cells.shape) != tuple(mask.shape) or cells.dtype != torch.int64 or cells.device != f.device:
        raise ValueError(f"the halo map must be {tuple(mask.shape)} int64 on {f.device}, "
                         f"got {tuple(cells.shape)} {cells.dtype} {cells.device}")
    m = halo.mask
    if (m.device, m.data_ptr(), m.shape, m.stride()) != (mask.device, mask.data_ptr(), mask.shape, mask.stride()):
        raise ValueError("the halo map was built from another mask (its stage marks follow the mask)")
    if not 0 < len(halo.tables) <= HALO_MAX_SEGMENTS:
        raise ValueError(f"a halo map takes 1 to {HALO_MAX_SEGMENTS} segments, got {len(halo.tables)}")
    Q = f.shape[lead + 1]
    for t in halo.tables:
        if t.kind not in FILL_KINDS or not 0 <= t.src < len(sources):
            raise ValueError(f"a halo segment's kind must be same, coarse, fine or values and its source a "
                             f"position in sources, got {t.kind!r}, {t.src}")
        src = sources[t.src]
        if t.kind == "values":
            if lead:
                raise ValueError("a payload segment takes no member axis")
            if (src.dim() != 2 or src.shape[1] != Q or src.shape[0] < t.rows or src.dtype != f.dtype
                    or src.device != f.device or not src.is_contiguous()):
                raise ValueError(f"payload {t.src} must be a contiguous (>= {t.rows}, {Q}) {f.dtype} tensor on "
                                 f"{f.device}, got {tuple(src.shape)} {src.dtype} {src.device}")
        elif (src.dim() != f.dim() or src.shape[:lead] != f.shape[:lead] or src.shape[lead + 1:] != f.shape[lead + 1:]
                or src.dtype != f.dtype or src.device != f.device):
            raise ValueError(f"source {t.src} {tuple(src.shape)} {src.dtype} does not match f {tuple(f.shape)} {f.dtype}")


def _stream_collide_halo(f, mask, halo: HaloMap, sources: tuple, out, members: MemberCoeffs | None, slots, kw: dict):
    """The halo route of :func:`lbm_stream_collide`, solo, over a slot list
    or over members."""
    lead = int(members is not None)
    if members is not None:
        _check_members(f, mask, members)
        lattice, collision, coeffs = members.lattice, members.collision, members.host
        trt, om_a, om_b = int(collision == "trt"), 0.0, 0.0  # from the member table
        lid = np.zeros(lattice.Q)
    else:
        lattice, collision = kw["lattice"], kw["collision"]
        _check(f, mask, lattice)
        coeffs, (trt, om_a, om_b), lid = _kernel_args(f.dtype, **kw)
    _check_slots(f, slots)
    _check_out(f, out)
    _check_halo(f, mask, halo, sources, lead)
    if out is not None and any(_overlap(out, t) for t in (f, *sources)):
        # the kernel stages a fine cell's means in its own slots of out, and
        # other CTAs read the sources while it runs
        raise ValueError("out must not overlap f or a source stack")
    if f.device.type == "cpu":
        return halo_stream_collide_ref(f, mask, coeffs, halo.tables, sources, lattice=lattice,
                                       collision=collision, slots=slots, out=out)
    srcs = [sources[t.src] for t in halo.tables]
    stack = f[0] if lead else f
    _check_card_operands(stack, f, mask, halo.cells, *srcs, *(t for t in (slots, out) if t is not None),
                         *((members.table,) if lead else ()))
    lib = _library(f.dtype, lattice.Q)
    if out is None:
        out = torch.empty(f.shape, dtype=f.dtype, device=f.device)
    nseg = len(halo.tables)
    B, _Q, X, Y, Z = stack.shape
    strides = ctypes.c_longlong * nseg
    with torch.cuda.device(f.device):
        err = lib.lbm_stream_collide_halo_map(
            _DTYPE_CODE[f.dtype], lattice.Q, trt, f.data_ptr(), mask.data_ptr(), out.data_ptr(),
            None if slots is None else slots.data_ptr(), 0 if slots is None else slots.numel(),
            members.table.data_ptr() if lead else None, f.shape[0] if lead else 1, B, X, Y, Z,
            om_a, om_b, lid.ctypes.data_as(ctypes.c_void_p), halo.cells.data_ptr(), nseg,
            (ctypes.c_void_p * nseg)(*(s.data_ptr() for s in srcs)),
            strides(*(s[0].numel() if lead else 0 for s in srcs)),
            strides(*(1 if t.kind == "values" else X * Y * Z for t in halo.tables)),
            _stream_ptr(f.device),
        )
    _raise_on(err, "lbm_stream_collide (halo)")
    lbm_stream_collide.launches += 1
    lbm_stream_collide.halo_launches += 1
    if slots is not None:
        lbm_stream_collide.slot_launches += 1
        lbm_stream_collide.halo_slot_launches += 1
    if lead:
        lbm_stream_collide.member_launches += 1
        lbm_stream_collide.halo_member_launches += 1
    return out


def lbm_halo_fill(
    dst: torch.Tensor,
    src: torch.Tensor,
    kind: str,
    dst_slot: torch.Tensor,
    dst_cell: torch.Tensor,
    src_slot: torch.Tensor | None = None,
    src_cell: torch.Tensor | None = None,
) -> None:
    """One segment of a ghost fill, written into ``dst``'s ghost ring in
    place: read from its source level's buffer, or (``"values"``) from the
    rows of an array.

    Args:
      dst:      (B_dst, Q, X, Y, Z) destination level's pre-step PDFs, or
                an ensemble's (M, B_dst, Q, X, Y, Z) member stacks: every
                member's segment is filled, in one launch.
      src:      (B_src, Q, X, Y, Z) source level's pre-step PDFs (may be
                ``dst`` itself for a same-level segment), (M, B_src, Q, X,
                Y, Z) with member stacks; for ``"values"`` (no member axis)
                an (N, Q) array whose row i fills row i's target.
      kind:     ``"same"``, ``"coarse"``, ``"fine"`` or ``"values"``.
      dst_slot, dst_cell: (N,) int32 target block and flat cell.
      src_slot: (N,) int32 source block; None for ``"values"``.
      src_cell: (N,) int32 source cell, or (N, 8) for ``"fine"`` (the octet
                in canonical order, averaged); None for ``"values"``.
    """
    lead = 1 if dst.dim() == 6 else 0  # the member axis
    stack = dst[0] if lead else dst
    Q = stack.shape[1] if stack.dim() == 5 else -1
    _check_block_stack(stack, Q)
    if kind not in FILL_KINDS:
        raise ValueError(f"unknown fill segment kind {kind!r}")
    if lead and kind == "values":
        raise ValueError("the values fill takes no member axis")
    N = dst_slot.shape[0] if dst_slot.dim() == 1 else -1
    if kind == "values":
        if tuple(src.shape) != (N, Q) or src.dtype != dst.dtype:
            raise ValueError(f"values src must be {(N, Q)} {dst.dtype}, got {tuple(src.shape)} {src.dtype}")
        if src_slot is not None or src_cell is not None:
            raise ValueError("a values fill takes no source indices")
        indices = (("dst_slot", dst_slot, (N,)), ("dst_cell", dst_cell, (N,)))
    else:
        if (src.dim() != dst.dim() or src.shape[:lead] != dst.shape[:lead]
                or src.shape[lead + 1:] != dst.shape[lead + 1:] or src.dtype != dst.dtype):
            raise ValueError(f"src {tuple(src.shape)} {src.dtype} does not match dst {tuple(dst.shape)} {dst.dtype}")
        cell_shape = (N, 8) if kind == "fine" else (N,)
        indices = (
            ("dst_slot", dst_slot, (N,)), ("dst_cell", dst_cell, (N,)),
            ("src_slot", src_slot, (N,)), ("src_cell", src_cell, cell_shape),
        )
    for name, t, shape in indices:
        if t is None or tuple(t.shape) != shape or t.dtype != torch.int32:
            raise ValueError(f"{name} must be {shape} int32, got {t if t is None else (tuple(t.shape), t.dtype)}")
    operands = (dst, src, *(t for _name, t, _shape in indices))
    if any(t.device != dst.device for t in operands):
        raise ValueError("the fill's operands must lie on one device")
    if dst.device.type == "cpu":
        halo_fill_ref(dst, src, kind, dst_slot, dst_cell, src_slot, src_cell)
        return
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("the fill's operands must be contiguous")
    if N == 0:
        return
    code = FILL_KINDS[kind]
    members, dst_stride, src_stride = (dst.shape[0], dst[0].numel(), src[0].numel()) if lead else (1, 0, 0)
    lib = _library(dst.dtype, Q)
    with torch.cuda.device(dst.device):
        err = lib.lbm_halo_fill(
            _DTYPE_CODE[dst.dtype], Q, code, dst.data_ptr(), src.data_ptr(), N,
            stack.shape[2] * stack.shape[3] * stack.shape[4], dst_slot.data_ptr(), dst_cell.data_ptr(),
            None if src_slot is None else src_slot.data_ptr(),
            None if src_cell is None else src_cell.data_ptr(), None,
            members, dst_stride, src_stride, _stream_ptr(dst.device),
        )
    _raise_on(err, "lbm_halo_fill")
    lbm_halo_fill.launches += 1
    lbm_halo_fill.kind_launches[(_MEMBER_KIND_NAMES if lead else _KIND_NAMES)[code]] += 1


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
    """Ghost fill from a padded slab + fused stream+collide over a stack of
    blocks (the interface of ``lbm_stream_collide_halo_pallas``).

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
    _check_card_operands(f, mask, halo_vals, halo_cell, halo_valid)
    lib = _library(f.dtype, Q)
    # the slab's rows in order: row b * P + p fills block b
    slot = torch.arange(B, dtype=torch.int32, device=f.device).repeat_interleave(P)
    with torch.cuda.device(f.device):
        err = lib.lbm_halo_fill(
            _DTYPE_CODE[f.dtype], Q, _FILL_VALUES, f.data_ptr(), halo_vals.data_ptr(), B * P,
            X * Y * Z, slot.data_ptr(), halo_cell.data_ptr(), None, None,
            halo_valid.data_ptr(), 1, 0, 0, _stream_ptr(f.device),
        )
    _raise_on(err, "lbm_stream_collide_halo (fill)")
    out = torch.empty(f.shape, dtype=f.dtype, device=f.device)
    _launch_stencil(lib, f, mask, out, trt, om_a, om_b, lid)
    lbm_stream_collide_halo.launches += 1
    return out


def reset_launches() -> None:
    """Zero every launch count of the wrappers."""
    lbm_stream_collide.launches = 0
    lbm_stream_collide.slot_launches = 0
    lbm_stream_collide.member_launches = 0
    lbm_stream_collide.halo_launches = 0
    lbm_stream_collide.halo_slot_launches = 0
    lbm_stream_collide.halo_member_launches = 0
    lbm_halo_fill.launches = 0
    lbm_halo_fill.kind_launches = dict.fromkeys(_KIND_NAMES + _MEMBER_KIND_NAMES, 0)
    lbm_stream_collide_halo.launches = 0


reset_launches()


def kernel_attributes() -> list[dict]:
    """What the compiler made of every kernel instantiation: registers,
    local-memory bytes (spills), static shared bytes, and resident CTAs of
    256 threads per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).
    Needs the card: it loads the built libraries."""
    rows = []
    out = (ctypes.c_int * 5)()
    variants = [("stencil", 0, v, name) for v, name in ((0, "bgk"), (1, "trt"), (2, "bgk+slots"), (3, "trt+slots"),
                                                        (4, "bgk+members"), (5, "trt+members"), (8, "bgk+halo"),
                                                        (9, "trt+halo"), (10, "bgk+slots+halo"),
                                                        (11, "trt+slots+halo"), (12, "bgk+halo+members"),
                                                        (13, "trt+halo+members"), (24, "bgk+halo+payloads"),
                                                        (25, "trt+halo+payloads"), (26, "bgk+slots+halo+payloads"),
                                                        (27, "trt+slots+halo+payloads"))]
    variants += [("fill", 1, v, name) for v, name in ((0, "copy"), (1, "fine"), (_FILL_VALUES, "values"))]
    for dtype, dcode in (("f32", 0), ("f64", 1)):
        for Q in (19, 27):
            lib = _library((torch.float32, torch.float64)[dcode], Q)
            for kernel, which, variant, name in variants:
                _raise_on(lib.lbm_kernel_attrs(which, dcode, Q, variant, out), "lbm_kernel_attrs")
                regs, local, shared, ctas, threads = out
                rows.append(dict(
                    kernel=kernel, variant=name, dtype=dtype, Q=Q, registers=regs,
                    local_bytes=local, shared_bytes=shared, ctas_per_sm=ctas,
                    occupancy=ctas * threads / 2048,
                ))
    return rows
