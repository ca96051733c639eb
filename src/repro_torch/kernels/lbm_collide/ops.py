"""Stepping entry points around the stream+collide and ghost-fill kernels.

Dispatches between the hand-written CUDA kernels (``backend="cuda"``, the
default; on a CPU tensor they take their plain PyTorch versions) and the
plain PyTorch versions chosen outright (``backend="ref"``). All
simulation-constant parameters (lattice, omega, wall velocity, collision
model) are closed over, so a step takes only the block stack and the mask.

The compiled superstep implements the halo-in-tile data plane: every active
level's ghost fill is merged into one fill (:func:`~..lbm.halo.lower_halo_fill`)
and folded into that level's halo step (:func:`make_halo_stream_collide`).
On the ``cuda`` backend the step is one launch of the stencil's halo route,
which reads each ghost value from its source in the substep's pre-step
buffers through the level's :func:`halo_map`, with no fill launch; on the
``ref`` backend the fill values are gathered with PyTorch index ops and
scattered into a copy. A coarse step is a plain Python loop over its
``2^lmax`` substeps with no host transfer in it.

The ensemble superstep (:func:`make_ensemble_superstep`) is the fused
superstep over an ensemble's member stacks ``(M, B, Q, X, Y, Z)``: the same
halo steps and stencils, each launched once for all M members through the
kernel's member axis, with per-member coefficients as operands.

The rank-sharded entry points (:func:`make_rank_emit`,
:func:`make_rank_absorb`, :func:`make_rank_absorb_split`) run one rank's
side of a sharded substep over that rank's own buffers: emit gathers the
outbound halo messages, absorb fills the rank's ghost cells from its local
sources and from the inbound messages' rows and steps the active levels.
With a halo stepper factory (the engines' form) a level's local rows and
message rows are one merged fill, and on the ``cuda`` backend one launch of
the stencil's halo route, which reads a message row straight from the
received payload; the split steps its interior and boundary blocks into
one output tensor through the route over a slot list. On ``cuda`` every
rank route runs over a slot list in neighbour order (:func:`neighbour_order`,
a full-length list for an unsplit level), so that each launch group of
the route's grid holds neighbouring blocks. Without one, the fills run
first (fill-kernel launches in place on ``cuda``, the messages through
the ``"values"`` kind), then the stencils.

The device superstep (:func:`make_device_superstep`) composes those pieces
for real device ranks: per ppermute round every sender's emit, zero-padded
to the round's shape, moves to its receiver's device in one copy, then every
rank absorbs on its own device.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ...lbm.halo import lower_halo_fill
from ...lbm.lattice import D3Q19, Lattice
from .lbm_collide import (
    HALO_FINE_BIT,
    HALO_GROUP,
    HALO_MAX_SEGMENTS,
    HALO_SEG_SHIFT,
    HALO_STAGE_BIT,
    HaloMap,
    MemberCoeffs,
    lbm_halo_fill,
    lbm_stream_collide,
)
from .ref import (
    _np_dtype,
    collision_coeffs,
    halo_fill_ref,
    precompute_stream_masks,
    stream_collide_halo_ref,
    stream_collide_into,
    stream_collide_ref,
)

__all__ = [
    "make_stream_collide",
    "make_arena_stream_collide",
    "make_halo_stream_collide",
    "fill_tables",
    "FillTable",
    "message_tables",
    "halo_map",
    "HaloStep",
    "apply_compiled_ghost_plan",
    "make_fused_superstep",
    "make_ensemble_superstep",
    "substep_patterns",
    "make_rank_emit",
    "boundary_slot_sets",
    "face_neighbours",
    "neighbour_order",
    "cube_groups",
    "make_rank_absorb",
    "make_rank_absorb_split",
    "shared_halo_steps",
    "make_device_superstep",
    "BACKENDS",
]

BACKENDS = ("cuda", "ref")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")


def make_stream_collide(
    *,
    omega: float,
    lattice: Lattice = D3Q19,
    u_wall: tuple[float, float, float] = (0.0, 0.0, 0.0),
    collision: str = "bgk",
    backend: str = "cuda",
):
    """Build ``step(f_blocks, mask_blocks, *, slots=None, out=None) ->
    f_blocks`` on (B, Q, X, Y, Z) stacks; the step runs on whichever device
    its tensors lie on. ``slots`` (an (S,) int32 tensor) steps only those
    blocks, into ``out`` (see :func:`~.lbm_collide.lbm_stream_collide`)."""
    _check_backend(backend)
    kw = dict(omega=omega, lattice=lattice, u_wall=u_wall, collision=collision)
    if backend == "cuda":

        def step(f: torch.Tensor, mask: torch.Tensor, *, slots=None, out=None) -> torch.Tensor:
            return lbm_stream_collide(f, mask, slots=slots, out=out, **kw)

    else:

        def step(f: torch.Tensor, mask: torch.Tensor, *, slots=None, out=None) -> torch.Tensor:
            return stream_collide_ref(f, mask, slots=slots, out=out, **kw)

    return step


def make_arena_stream_collide(
    *,
    omega: float,
    lattice: Lattice = D3Q19,
    u_wall: tuple[float, float, float] = (0.0, 0.0, 0.0),
    collision: str = "bgk",
    backend: str = "cuda",
):
    """Arena entry point: an in-place ``step(f_buf, mask) -> None`` over a
    persistent :class:`~..core.fields.LevelArena` buffer.

    ``f_buf`` is the level's contiguous host ``(B, Q, X, Y, Z)`` buffer; it
    is uploaded whole to ``mask``'s device (one host->device copy, no
    per-block restacking), stepped, and the result copied back into the same
    buffer, so all per-block views bound by the arena stay valid. That round
    trip every substep is the arena mode's contract. ``mask`` is the
    device mask stack, cached by the caller across substeps.
    """
    step = make_stream_collide(
        omega=omega, lattice=lattice, u_wall=u_wall, collision=collision, backend=backend
    )

    def step_arena(f_buf: np.ndarray, mask: torch.Tensor) -> None:
        host = torch.from_numpy(f_buf)
        host.copy_(step(host.to(mask.device), mask))

    return step_arena


# -- halo-in-tile stepping -------------------------------------------------------


def _pad_fill_layout(
    dst_slot: np.ndarray, dst_cell: np.ndarray, nblocks: int, dims: tuple[int, int, int]
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Repack a flat merged fill into the per-block padded slab layout of
    :func:`~.lbm_collide.lbm_stream_collide_halo` (the Pallas halo kernel's
    interface; the main path does not use it).

    Returns ``(entry, cell, valid)``, each ``(nblocks, P)`` with ``P`` the
    max fills per block: ``entry[b, j]`` indexes the fill's concatenated
    value rows, ``cell[b, j]`` the flat ghosted-box cell to write. Padding
    rows point at the box's center cell — an interior cell that is never a
    halo target (all targets lie in the ghost ring) — with ``valid`` False,
    so the kernel leaves that cell as it is."""
    n = int(dst_cell.size)
    pad_cell = (dims[0] // 2 * dims[1] + dims[1] // 2) * dims[2] + dims[2] // 2
    assert not np.any(dst_cell == pad_cell), "halo fill targeted the pad cell"
    counts = np.bincount(dst_slot, minlength=nblocks)
    assert counts.size == nblocks, (counts.size, nblocks)
    P = int(counts.max()) if n else 0
    entry = np.zeros((nblocks, P), dtype=np.int32)
    cell = np.full((nblocks, P), pad_cell, dtype=np.int32)
    valid = np.zeros((nblocks, P), dtype=bool)
    order = np.argsort(dst_slot, kind="stable")
    pos = 0
    for b in range(nblocks):
        k = int(counts[b])
        idx = order[pos : pos + k]
        pos += k
        entry[b, :k] = idx
        cell[b, :k] = dst_cell[idx]
        valid[b, :k] = True
    return entry, cell, valid


# repro: host-ok(plan index arrays are host numpy, uploaded once per program build)
def _index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


@dataclass(frozen=True)
class FillTable:
    """One segment of a level's merged fill, lowered for
    :func:`~.lbm_collide.lbm_halo_fill` and :func:`halo_map`: int32 index
    tensors on the device, rows sorted by (``dst_slot``, ``dst_cell``).
    ``src`` is the source level's position in the superstep's buffer tuple;
    ``src_slot`` is ``(N,)`` for every kind (a fine row's octet lies in one
    block) and ``src_cell`` ``(N,)``, or ``(N, 8)`` for ``"fine"``.

    A ``"values"`` table is one inbound payload's rows at a rank's level
    (:func:`message_tables`): ``src`` is the payload's position in the halo
    route's sources (after the pre-step tuple), ``src_cell`` the payload
    row of each target, in the message's order, ``src_slot`` None, and
    ``rows`` the least rows the payload must hold."""

    src: int
    kind: str  # "same" | "fine" | "coarse" | "values"
    dst_slot: torch.Tensor
    dst_cell: torch.Tensor
    src_slot: torch.Tensor | None
    src_cell: torch.Tensor
    rows: int = 0


# repro: host-ok(build-time sort of host plan arrays, once per superstep build)
def fill_tables(fill, level_index: dict[int, int], device: torch.device | str) -> tuple[FillTable, ...]:
    """Lower a :class:`~..lbm.halo.LevelHaloFill` into one sorted
    :class:`FillTable` per segment (built once per superstep build)."""
    tables = []
    start = 0
    for seg in fill.segments:
        stop = start + seg.src_cell.shape[0]
        ds, dc = fill.dst_slot[start:stop], fill.dst_cell[start:stop]
        # one int64 key (targets are unique): about half the time of a
        # two-key lexsort on the millions of rows of a fine level
        order = np.argsort(np.asarray(ds, np.int64) * (int(dc.max(initial=0)) + 1) + dc)
        ss = seg.src_slot
        if seg.kind == "fine":
            assert (ss == ss[:, :1]).all(), "a fine row's octet must lie in one block"
            ss = ss[:, 0]
        tables.append(FillTable(
            level_index[seg.src_level],
            seg.kind,
            *(
                torch.as_tensor(np.ascontiguousarray(a[order], dtype=np.int32), device=device)
                for a in (ds, dc, ss, seg.src_cell)
            ),
        ))
        start = stop
    assert start == fill.num_cells, (start, fill.num_cells)
    return tuple(tables)


# repro: host-ok(build-time lowering of host plan arrays, once per program build)
def message_tables(messages, first: int, device: torch.device | str) -> tuple[FillTable, ...]:
    """Lower one rank level's inbound message rows into one ``"values"``
    :class:`FillTable` a payload. ``messages`` are ``(payload, dst_slot,
    dst_cell, offset, n)`` tuples: the ``n`` rows of the payload at position
    ``payload`` among the received ones, from row ``offset`` on, fill those
    targets (one tuple a scatter segment of the message, in its order).
    ``first`` is the first payload's position in the halo route's sources
    (the length of the pre-step tuple)."""
    per: dict[int, list] = {}
    for mi, db, dc, off, n in messages:
        per.setdefault(mi, []).append((db, dc, np.arange(off, off + n)))
    tables = []
    for mi, parts in per.items():
        db, dc, rows = (np.concatenate([p[k] for p in parts]) for k in range(3))
        tables.append(FillTable(
            first + mi, "values", *(_int32(a, device) for a in (db, dc)), None, _int32(rows, device),
            int(rows.max(initial=-1)) + 1,
        ))
    return tuple(tables)


def halo_map(tables: tuple[FillTable, ...], mask: torch.Tensor, Q: int) -> HaloMap:
    """The halo route's map of one level's fill, built once per superstep
    build beside its :func:`fill_tables` (and a rank level's
    :func:`message_tables`), on their device: the target of each row of
    ``tables[k]`` holds ``k << HALO_SEG_SHIFT`` (and a fine row's ``1 <<
    HALO_FINE_BIT``) or'ed with the element offset of the row's source cell
    (a fine row's octet base) in a source stack of ``Q`` directions, or of
    a ``"values"`` row's payload row (its row times ``Q``), every other
    cell of the level -1. A rank level's map holds its local and its
    message rows; at most :data:`HALO_MAX_SEGMENTS` tables. ``mask`` is the
    level's
    (B, X, Y, Z) cell-type stack on the tables' device, the one the route
    is launched with: a fine row's target also holds ``1 <<
    HALO_STAGE_BIT`` where the stencil reads the cell's own values, that is
    where the cell or one of its 26 neighbours (wrapped within the block,
    as the stencil wraps) is not fluid. A fine row's octet must be the
    canonical 2 x 2 x 2 cube at its base (checked), so that the base alone
    names it."""
    dev = tables[0].dst_slot.device
    if len(tables) > HALO_MAX_SEGMENTS:
        raise ValueError(f"a halo map takes at most {HALO_MAX_SEGMENTS} segments, got {len(tables)}")
    if mask.dim() != 4 or mask.device != dev:
        raise ValueError(f"the mask must be a (B, X, Y, Z) stack on {dev}, got {tuple(mask.shape)} on {mask.device}")
    nblocks, *dims = mask.shape
    n = int(np.prod(dims))
    _X, Y, Z = dims
    octet = torch.tensor([dx * Y * Z + dy * Z + dz for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)], device=dev)
    solid = mask != 0
    reads = solid.clone()
    for shift in itertools.product((-1, 0, 1), repeat=3):
        reads |= torch.roll(solid, shift, dims=(1, 2, 3))
    reads = reads.reshape(-1)
    cells = torch.full((nblocks * n,), -1, dtype=torch.int64, device=dev)
    for k, t in enumerate(tables):
        base = t.src_cell.long()
        dst = t.dst_slot.long() * n + t.dst_cell.long()
        if t.kind == "values":  # a payload row: its Q values are adjacent
            cells[dst] = base * Q | k << HALO_SEG_SHIFT
            continue
        value = t.src_slot.long() * (Q * n) | k << HALO_SEG_SHIFT
        if t.kind == "fine":
            assert torch.equal(base - base[:, :1], octet.expand_as(base)), "a fine row's octet is not canonical"
            base = base[:, 0]
            value = value | 1 << HALO_FINE_BIT | reads[dst].long() << HALO_STAGE_BIT
        cells[dst] = value + base
    return HaloMap(cells.view(nblocks, *dims), tables, mask)


# repro: host-ok(build-time check over host plan arrays, once per branch build)
def _assert_fills_disjoint(
    fills: dict, level_index: dict[int, int], nblocks: list[int], cells: int, messages=()
) -> None:
    """The fills of one substep may run in any order, in place, before any
    level steps only if no ghost cell is filled twice and no fill reads a
    cell that a fill writes. ``messages`` are a rank's inbound
    :class:`~..lbm.halo.CompiledRankMessage` specs: their targets count as
    written cells too. Checked on the host when a branch is built, with one
    flag a cell and no sort."""
    base = np.concatenate([[0], np.cumsum(np.asarray(nblocks, dtype=np.int64) * cells)])

    def key(level, slot, cell):
        return base[level_index[level]] + np.asarray(slot, np.int64) * cells + cell

    targets = [key(l, f.dst_slot, f.dst_cell) for l, f in fills.items()]
    targets += [key(dl, db, dc) for m in messages for dl, db, dc, _n in m.scatter]
    if not targets:
        return
    tgt = np.concatenate(targets)
    written = np.zeros(int(base[-1]), dtype=bool)
    written[tgt] = True
    assert np.count_nonzero(written) == tgt.size, "a ghost cell is filled twice"
    for f in fills.values():
        for seg in f.segments:
            src = key(seg.src_level, seg.src_slot, seg.src_cell)
            assert not written[src.ravel()].any(), (
                f"a fill of level {f.dst_level} reads a cell of level {seg.src_level} that a fill writes"
            )


def _same_fill(a, b) -> bool:
    """Whether two merged fills of one level are the same index map."""
    if len(a.segments) != len(b.segments) or any(
        (s.src_level, s.kind) != (r.src_level, r.kind) for s, r in zip(a.segments, b.segments)
    ):
        return False
    pairs = [(a.dst_slot, b.dst_slot), (a.dst_cell, b.dst_cell)]
    pairs += [(x, y) for s, r in zip(a.segments, b.segments) for x, y in
              ((s.src_slot, r.src_slot), (s.src_cell, r.src_cell))]
    return all(np.array_equal(x, y) for x, y in pairs)


@dataclass(frozen=True)
class HaloStep:
    """One level's halo step in two phases. ``fill(sources)`` runs on the
    substep's pre-step tuple (on a rank path followed by the received
    payloads), for every level that has a fill, before any level of the
    substep steps, and returns what ``step(f, filled, *, slots=None,
    out=None)`` needs to finish the level, or the listed blocks of it into
    ``out``. Given the pre-step tuple alone, a step with message rows
    reads its local rows only (a rank's interior half, whose blocks name
    no payload row). ``local_rows`` and ``message_rows`` count the rows of
    each kind, ``map_bytes`` the ``cuda`` backend's map (8 bytes a cell)."""

    fill: Callable[[tuple], object]
    step: Callable[..., torch.Tensor]
    local_rows: int = 0
    message_rows: int = 0
    map_bytes: int = 0


def make_halo_stream_collide(
    fill,
    level_index: dict[int, int],
    *,
    messages=(),
    mask: np.ndarray | torch.Tensor,
    omega: float,
    lattice: Lattice = D3Q19,
    u_wall: tuple[float, float, float] = (0.0, 0.0, 0.0),
    collision: str = "bgk",
    magic: float = 3.0 / 16.0,
    backend: str = "cuda",
    device: torch.device | str = "cuda",
) -> HaloStep:
    """Build the halo step of one level: its merged ghost fill ``fill``
    (a :class:`~..lbm.halo.LevelHaloFill`, or None on a rank level whose
    rows all come in messages) and, on a rank path, the rows ``messages``
    of the inbound payloads (:func:`message_tables`'s tuples), then the
    stream+collide stencil.

    ``level_index`` maps levels to positions in the superstep's buffer
    tuple; payload ``i`` follows it in the sources, at ``len(level_index) +
    i``. On the ``cuda`` backend ``fill(sources)`` only hands the sources
    on, and ``step`` is one launch of the stencil's halo route
    (:func:`~.lbm_collide.lbm_stream_collide` with the level's
    :func:`halo_map`, over ``slots`` when given): each ghost value it needs
    is read from its source, a pre-step stack or a payload row, and no
    buffer is written but the output. On the ``ref`` backend
    ``fill(sources)`` gathers the ``(N, Q)`` fill values, the local rows'
    then the message rows' (slices of the payloads), and ``step`` scatters
    them into a copy of ``f`` feeding the stencil, with the streaming
    selectors precomputed on the host (:func:`~.ref.precompute_stream_masks`)
    where ``mask`` is a host array.

    ``mask`` is the level's ``(B, X, Y, Z)`` cell-type stack, a host array
    (uploaded to ``device``) or a tensor on ``device`` (used as it is),
    closed over as a constant (programs are rebuilt on mask refresh / AMR
    events).
    """
    _check_backend(backend)
    device = torch.device(device)
    if not isinstance(mask, torch.Tensor):
        mask = np.asarray(mask)  # repro: host-ok(the host mask stack closed over at program build)
    mask_t = torch.as_tensor(mask, device=device)
    messages = tuple(messages)
    local_rows = 0 if fill is None else fill.num_cells
    message_rows = sum(n for *_r, n in messages)
    assert local_rows + message_rows > 0, "use make_stream_collide when there is no fill"
    kw = dict(omega=omega, lattice=lattice, u_wall=u_wall, collision=collision, magic=magic)
    npre = len(level_index)

    if backend == "cuda":
        local = fill_tables(fill, level_index, device) if local_rows else ()
        hmap = halo_map(local + message_tables(messages, npre, device), mask_t, lattice.Q)
        # the map of the local rows alone: the same cells, read only by
        # blocks that name no payload row
        local_map = hmap if not messages else (HaloMap(hmap.cells, local, mask_t) if local else None)

        def step(f: torch.Tensor, sources: tuple, *, slots=None, out=None) -> torch.Tensor:
            halo = hmap if len(sources) > npre else local_map
            if halo is None:  # no local row, and no payload bound
                return lbm_stream_collide(f, mask_t, slots=slots, out=out, **kw)
            return lbm_stream_collide(f, mask_t, halo=halo, sources=sources, slots=slots, out=out, **kw)

        return HaloStep(lambda sources: sources, step, local_rows, message_rows,
                        hmap.cells.numel() * hmap.cells.element_size())

    if isinstance(mask, np.ndarray):
        pm = {k: torch.as_tensor(v, device=device) for k, v in precompute_stream_masks(mask, lattice).items()}
        sel = dict(premask=pm)
    else:
        sel = dict(mask=mask_t)
    parts = ([(fill.dst_slot, fill.dst_cell)] if local_rows else []) + [(db, dc) for _mi, db, dc, _o, _n in messages]
    db = _index(np.concatenate([a for a, _b in parts]), device)
    dc = _index(np.concatenate([b for _a, b in parts]), device)
    gathers = _lower_fill_gathers(fill, level_index, device) if local_rows else ()
    slices = tuple((npre + mi, off, n) for mi, _db, _dc, off, n in messages)

    def fill_ref(sources: tuple) -> torch.Tensor | None:
        extra = [sources[i][off : off + n] for i, off, n in slices] if len(sources) > npre else []
        if not gathers and not extra:
            return None
        return _concat_vals(sources, gathers, extra)

    def step_ref(f: torch.Tensor, vals: torch.Tensor | None, *, slots=None, out=None) -> torch.Tensor:
        coeffs = collision_coeffs(**kw, dtype=_np_dtype(f.dtype))
        if vals is None:
            return stream_collide_into(f, mask_t, coeffs, lattice=lattice, collision=collision, slots=slots, out=out)
        n = vals.shape[0]  # the local rows come first
        if slots is None:
            res = stream_collide_halo_ref(f, vals, db[:n], dc[:n], coeffs, lattice=lattice, collision=collision, **sel)
            return res if out is None else out.copy_(res)
        filled = f.clone()
        _flat3(filled)[db[:n], :, dc[:n]] = vals
        return stream_collide_into(filled, mask_t, coeffs, lattice=lattice, collision=collision, slots=slots, out=out)

    return HaloStep(fill_ref, step_ref, local_rows, message_rows)


def _device_plan_ops(plan, level_index: dict[int, int], device: torch.device) -> list[tuple]:
    """Lower a :class:`~..lbm.halo.CompiledGhostPlan` for one field into
    device-ready (dst idx, src idx, kind, index tensors) tuples, mapping
    levels to positions in the superstep's buffer tuple."""
    return [
        (
            level_index[op.dst_level],
            level_index[op.src_level],
            op.kind,
            _index(op.dst_slot, device),
            _index(op.dst_cell, device),
            _index(op.src_slot, device),
            _index(op.src_cell, device),
        )
        for op in plan.ops
    ]


def _flat3(a: torch.Tensor) -> torch.Tensor:
    """(B, *lead, X, Y, Z) -> (B, C, cells) view, C the flattened lead axes."""
    return a.view(a.shape[0], -1, a.shape[-3] * a.shape[-2] * a.shape[-1])


def _gather_vals(s: torch.Tensor, kind: str, sb, sc) -> torch.Tensor:
    """Gather (and sender-side resample) one exchange segment: (N, C) values."""
    flat = _flat3(s)
    if kind == "fine":
        v = flat[sb, :, sc]  # (N, 8, C): octet gather in canonical order
        acc = v[:, 0]
        for k in range(1, 8):  # fixed-sequence sum == host _extract
            acc = acc + v[:, k]
        if s.dtype.is_floating_point:
            return acc * 0.125
        return (acc / 8).to(s.dtype)  # int fields: truncating divide
    return flat[sb, :, sc]  # same / coarse: plain (possibly replicating) gather


def _run_plan_ops(ops: list[tuple], bufs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Execute lowered exchange ops on (B, *lead, X, Y, Z) per-level
    buffers, scattering into them in place, op by op."""
    for dst, src, kind, db, dc, sb, sc in ops:
        _flat3(bufs[dst])[db, :, dc] = _gather_vals(bufs[src], kind, sb, sc)
    return bufs


def _lower_fill_gathers(fill, level_index: dict[int, int], device: torch.device) -> tuple:
    """Device-ready gather specs for a merged fill's value segments."""
    return tuple(
        (
            level_index[seg.src_level],
            seg.kind,
            _index(seg.src_slot, device),
            _index(seg.src_cell, device),
        )
        for seg in fill.segments
    )


def _concat_vals(bufs, gathers, extra=()) -> torch.Tensor:
    """Concatenate gathered segment values (then any given value rows, such
    as inbound message slices) in merged-fill order."""
    parts = [_gather_vals(bufs[si], kind, sb, sc) for si, kind, sb, sc in gathers] + list(extra)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def apply_compiled_ghost_plan(plan, bufs: dict[int, np.ndarray | torch.Tensor]) -> dict[int, torch.Tensor]:
    """Run one compiled single-field ghost exchange on per-level buffers.

    ``bufs`` maps level -> (B, *lead, X, Y, Z) array or tensor; the inputs
    are copied, and a new dict of updated tensors (on the inputs' device) is
    returned. This is the building block :func:`make_fused_superstep`
    composes, exposed so tests can pin compiled-vs-host exchange directly.
    """
    assert len({op.field for op in plan.ops}) <= 1, (
        "apply_compiled_ghost_plan executes one field's buffers; compile "
        "multi-field exchanges as one plan per field"
    )
    levels = sorted(bufs)
    index = {l: i for i, l in enumerate(levels)}
    copies = [torch.as_tensor(bufs[l]).clone() for l in levels]
    out = _run_plan_ops(_device_plan_ops(plan, index, copies[0].device), copies)
    return dict(zip(levels, out))


def substep_patterns(lmax: int) -> list[int]:
    """Activity pattern of each substep of a coarse step: the trailing zeros
    of ``s`` (``s = 0`` activates every level)."""
    return [lmax if s == 0 else min((s & -s).bit_length() - 1, lmax) for s in range(1 << lmax)]


def make_fused_superstep(*, levels, plans, steppers, masks, halo_stepper_factory):
    """One full coarse step — the whole ``2^lmax`` substep cycle with
    interleaved ghost exchange — as one device-resident function.

    Per substep ``s`` the active level set is ``{l : s % 2^(lmax-l) == 0}``,
    which depends only on the number of trailing zeros of ``s``; there are
    therefore just ``lmax+1`` distinct *activity patterns*, each built once
    as a branch. A branch runs the halo-in-tile schedule: every active
    level's ghost fill is merged into one fill
    (:func:`~..lbm.halo.lower_halo_fill`), and every active level steps,
    finest first, each reading its sources from the substep's pre-step
    tuple. On the ``cuda`` backend a level with a fill is one launch of the
    stencil's halo route, which reads each ghost value from its source;
    on ``ref`` every level's fill values are gathered first, then each
    level scatters them into a copy and steps. Sources are interior cells,
    targets ghost cells, and no target repeats (asserted on the host when
    the branch is built), so this equals the sequential per-op schedule bit
    for bit. A level whose fill is the same in several patterns (the finest
    level's, in practice) gets one halo step, built once and shared by those
    branches. The pre-step tuple stays referenced until the branch returns,
    so the caching allocator cannot hand a source stack out again while a
    later level still reads it. The substeps run as a plain Python loop;
    nothing touches the host.

    The superstep consumes its input tuple: callers rebind the result
    (``pdfs = superstep(pdfs)``) and never read the arrays they passed in.

    Args:
        levels: refinement levels in use (the buffer tuple's order is the
            ascending sort of this).
        plans: pattern index ``p`` (0..lmax) -> compiled ghost plan for the
            active set ``{l : l >= lmax - p}``.
        steppers: level -> ``step(f, mask) -> f`` (from
            :func:`make_stream_collide`), used for active levels with no fill.
        masks: level -> device mask stack for that level's buffer.
        halo_stepper_factory: ``(level, fill, level_index) -> HaloStep``
            builder (see :func:`make_halo_stream_collide`).

    Returns:
        ``superstep(pdfs: tuple) -> tuple`` advancing one coarse step;
        ``pdfs`` holds one (B, Q, X, Y, Z) tensor per level, ascending.
        Its ``fill_segments`` attribute counts the fill segments a coarse
        step runs (the ``ref`` backend's gathers), ``halo_steps`` the
        (substep, level) steps with a fill (the ``cuda`` backend's halo
        launches; it launches no fill).
    """
    levels = tuple(sorted(levels))
    index = {l: i for i, l in enumerate(levels)}
    lmax = levels[-1]
    masks_t = tuple(masks[l] for l in levels)
    nblocks = [m.shape[0] for m in masks_t]
    cells = int(np.prod(masks_t[0].shape[1:]))
    built: dict[int, list] = {}  # level -> [(fill, HaloStep)] of earlier branches

    def halo_step(l: int, fill) -> HaloStep:
        for other, hstep in built.setdefault(l, []):
            if _same_fill(fill, other):
                return hstep
        hstep = halo_stepper_factory(l, fill, index)
        built[l].append((fill, hstep))
        return hstep

    def make_branch(p: int):
        active = tuple(sorted((l for l in levels if l >= lmax - p), reverse=True))
        fills = lower_halo_fill(plans[p])
        assert set(fills) <= set(active), (sorted(fills), active)
        _assert_fills_disjoint(fills, index, nblocks, cells)
        hsteps = {l: halo_step(l, f) for l, f in fills.items()}
        filling = [l for l in active if l in fills]  # finest first

        def branch(pdfs):
            bufs = list(pdfs)
            filled = {l: hsteps[l].fill(pdfs) for l in filling}
            for l in active:  # finest first
                i = index[l]
                if l in fills:
                    bufs[i] = hsteps[l].step(pdfs[i], filled[l])
                else:
                    bufs[i] = steppers[l](pdfs[i], masks_t[i])
            return tuple(bufs)

        branch.fill_segments = sum(len(f.segments) for f in fills.values())
        branch.halo_steps = len(filling)
        return branch

    branches = [make_branch(p) for p in range(lmax + 1)]
    pattern = substep_patterns(lmax)

    def superstep(pdfs):
        pdfs = tuple(pdfs)
        for p in pattern:
            pdfs = branches[p](pdfs)
        return pdfs

    superstep.fill_segments = sum(branches[p].fill_segments for p in pattern)
    superstep.halo_steps = sum(branches[p].halo_steps for p in pattern)
    return superstep


def make_ensemble_superstep(
    *,
    levels,
    plans,
    masks,
    lattice: Lattice = D3Q19,
    collision: str = "bgk",
    backend: str = "cuda",
    device: torch.device | str = "cuda",
):
    """One coarse step for a whole *ensemble* of independent members that
    share one forest topology: :func:`make_fused_superstep` with a leading
    member axis, per-member physics coefficients as operands.

    The counterpart of the JAX package's ``vmap`` over members. The
    schedule is the fused superstep's: the same ``lmax+1`` activity
    patterns (each distinct level fill lowered once and shared by the
    patterns that run it, the fills checked disjoint on the host), every
    active level stepped finest first from the substep's pre-step tuple.
    On the ``cuda`` backend a level with a fill is one launch of the
    stencil's halo route (:func:`~.lbm_collide.lbm_stream_collide` with
    ``halo`` and ``members``) and a level without one a member stencil
    launch, each for **all** members (the kernel's member axis), so a batch
    launches exactly what one member's fused coarse step launches, whatever
    M is. On the ``ref`` backend every level's fill runs first as the plain
    fill over the member axis (:func:`~.ref.halo_fill_ref`, a gather and a
    scatter a segment, in place into the pre-step stacks), then the plain
    stencils (:func:`~.ref.stream_collide_into`). Either way member ``m``
    of the result has the bits of a solo fused superstep with ``m``'s
    coefficients: coefficients are rounded to the field's dtype on the host
    and only ever multiply (``ref.py``), the fills write ghost cells from
    interior cells, and every kernel is block-local and fixed-order.

    Args:
        levels: refinement levels in use (ascending buffer-tuple order).
        plans: pattern index ``p`` (0..lmax) -> compiled ghost plan for the
            active set ``{l : l >= lmax - p}``, in one member's slot layout
            (all members share it, since they share the topology).
        masks: level -> host (B, X, Y, Z) mask stack shared by every
            member (copied to ``device`` once).
        lattice / collision: the kernel configuration the whole ensemble
            shares.
        backend / device: as for :func:`make_halo_stream_collide`.

    Returns:
        ``superstep(pdfs: tuple, coeffs: dict) -> tuple`` advancing one
        coarse step: ``pdfs`` holds one ``(M, B, Q, X, Y, Z)`` tensor per
        level (ascending), ``coeffs`` maps level ->
        :class:`~.lbm_collide.MemberCoeffs` of the M members. It consumes
        its input tuple. Its ``stencils`` attribute counts the stencil
        launches of a coarse step on ``cuda``, ``halo_steps`` those of them
        through the halo route, and ``fill_segments`` the fill segments
        (the ``ref`` backend's fills; ``cuda`` launches no fill).
    """
    _check_backend(backend)
    device = torch.device(device)
    levels = tuple(sorted(levels))
    index = {l: i for i, l in enumerate(levels)}
    lmax = levels[-1]
    # repro: host-ok(host mask stacks of the arena, read once per program build)
    masks_host = tuple(np.asarray(masks[l]) for l in levels)
    masks_t = tuple(torch.tensor(m, device=device) for m in masks_host)  # copies
    nblocks = [m.shape[0] for m in masks_host]
    cells = int(np.prod(masks_host[0].shape[1:]))
    built: dict[int, list] = {}  # level -> [(fill, tables or halo map)] of earlier branches

    def lowered(l: int, fill):
        """The fill's tables (``ref``) or halo map (``cuda``), shared by
        every branch with the same fill."""
        for other, low in built.setdefault(l, []):
            if _same_fill(fill, other):
                return low
        low = fill_tables(fill, index, device)
        if backend == "cuda":
            low = halo_map(low, masks_t[index[l]], lattice.Q)
        built[l].append((fill, low))
        return low

    def make_branch(p: int):
        active = tuple(sorted((l for l in levels if l >= lmax - p), reverse=True))
        fills = lower_halo_fill(plans[p])
        assert set(fills) <= set(active), (sorted(fills), active)
        _assert_fills_disjoint(fills, index, nblocks, cells)
        low = {l: lowered(l, f) for l, f in fills.items()}
        filling = [l for l in active if l in fills]  # finest first

        if backend == "cuda":

            def branch(pdfs, coeffs):
                bufs = list(pdfs)
                for l in active:  # finest first, every level from the pre-step tuple
                    i = index[l]
                    halo = dict(halo=low[l], sources=pdfs) if l in low else {}
                    bufs[i] = lbm_stream_collide(pdfs[i], masks_t[i], members=coeffs[l], **halo)
                return tuple(bufs)

        else:

            def branch(pdfs, coeffs):
                bufs = list(pdfs)
                for l in filling:  # every fill reads the pre-step buffers
                    i = index[l]
                    for t in low[l]:
                        halo_fill_ref(bufs[i], bufs[t.src], t.kind, t.dst_slot, t.dst_cell, t.src_slot, t.src_cell)
                for l in active:  # finest first
                    i = index[l]
                    bufs[i] = stream_collide_into(bufs[i], masks_t[i], coeffs[l].host, lattice=lattice,
                                                  collision=collision)
                return tuple(bufs)

        branch.fill_segments = sum(len(f.segments) for f in fills.values())
        branch.halo_steps = len(filling)
        branch.stencils = len(active)
        return branch

    branches = [make_branch(p) for p in range(lmax + 1)]
    pattern = substep_patterns(lmax)

    def superstep(pdfs, coeffs):
        pdfs = tuple(pdfs)
        for p in pattern:
            pdfs = branches[p](pdfs, coeffs)
        return pdfs

    superstep.fill_segments = sum(branches[p].fill_segments for p in pattern)
    superstep.halo_steps = sum(branches[p].halo_steps for p in pattern)
    superstep.stencils = sum(branches[p].stencils for p in pattern)
    return superstep


# -- rank-sharded substep ----------------------------------------------------------


def make_rank_emit(messages, level_index: dict[int, int], device: torch.device | str, rows=None):
    """Build one rank's message-building side of a sharded exchange.

    ``messages`` are the :class:`~..lbm.halo.CompiledRankMessage` specs whose
    ``src_rank`` is this rank; ``level_index`` maps the rank's levels to
    positions in its buffer tuple. Returns ``emit(pdfs: tuple) -> tuple``
    producing one ``(N, Q)`` row-major payload per message on the rank's
    device (sender-side resampled by :func:`_gather_vals`, segments
    concatenated in the spec's canonical order), so ``m.nbytes`` is the
    payload's size. Returns ``None`` when the rank sends nothing.

    ``rows`` optionally gives each message's payload row count, at least its
    ``num_cells``: the payload is zero-padded to it (the device fabric ships
    one shape a round, :class:`~..lbm.halo.PpermuteRound`), and the zero
    rows ride in the same ``cat`` as the segments.

    ``emit`` only reads the pdf buffers: the absorb programs dispatched
    after it in the same substep write their ghost cells in place, and
    emits read interior cells only.
    """
    if not messages:
        return None
    device = torch.device(device)
    specs = tuple(
        tuple(
            (level_index[src_level], kind, _index(sb, device), _index(sc, device))
            for src_level, kind, sb, sc in m.gather
        )
        for m in messages
    )
    pads = tuple(0 for _m in messages) if rows is None else tuple(n - m.num_cells for n, m in zip(rows, messages, strict=True))
    assert min(pads) >= 0, pads
    zeros = {}  # dtype -> the zero rows of the largest pad, made at the first call

    def emit(pdfs):
        out = []
        for segs, pad in zip(specs, pads):
            parts = [_gather_vals(pdfs[li], kind, sb, sc) for li, kind, sb, sc in segs]
            if pad:
                z = zeros.get(parts[0].dtype)
                if z is None:
                    z = zeros[parts[0].dtype] = parts[0].new_zeros((max(pads), parts[0].shape[1]))
                parts.append(z[:pad])
            out.append(parts[0] if len(parts) == 1 else torch.cat(parts, dim=0))
        return tuple(out)

    return emit


def boundary_slot_sets(messages, masks) -> dict[int, frozenset[int]]:
    """Per-level sets of block slots whose ghost layer depends on inbound
    cross-rank messages (the *boundary* blocks of a rank). ``masks`` maps
    the rank's levels to their (B, ...) stacks (only shapes are read)."""
    bnd: dict[int, set[int]] = {l: set() for l in masks}
    for m in messages:
        for dl, db, _dc, _n in m.scatter:
            bnd.setdefault(dl, set()).update(int(s) for s in np.unique(db))
    return {l: frozenset(s) for l, s in bnd.items()}


# the weight of a shared face by axis (x, y, z) when blocks are grouped: a
# z-face ghost cell and its source each lie alone in a 32-byte sector, so a
# source row that a neighbour's CTA reads at the same time (an L2 hit) saves
# the most there; a y-face source row is read by the neighbour's CTA of the
# same x plane too; an x-face source plane at another time
_FACE_WEIGHT = (1, 3, 9)


# repro: host-ok(build-time scan of host plan arrays, once per program build)
def face_neighbours(fill, dims) -> dict[int, dict[int, int]]:
    """A level's same-level face neighbours, from its merged local fill (a
    :class:`~..lbm.halo.LevelHaloFill`, or None): block -> {neighbour:
    axis (0 x, 1 y, 2 z)}. A same-level neighbour fills a whole face of the
    ghost layer, so the ``"same"`` rows of the 6 face centres name them
    all. ``dims`` is the block's cells (ghost layer included)."""
    out: dict[int, dict[int, int]] = {}
    if fill is None:
        return out
    X, Y, Z = dims
    cx, cy, cz = X // 2, Y // 2, Z // 2
    axis_of = {(x * Y + y) * Z + z: i // 2 for i, (x, y, z) in enumerate(
        ((0, cy, cz), (X - 1, cy, cz), (cx, 0, cz), (cx, Y - 1, cz), (cx, cy, 0), (cx, cy, Z - 1)))}
    start = 0
    for seg in fill.segments:
        stop = start + seg.src_cell.shape[0]
        if seg.kind == "same" and seg.src_level == fill.dst_level:
            dc = np.asarray(fill.dst_cell[start:stop])
            for row in np.flatnonzero(np.isin(dc, list(axis_of))):
                a, b, axis = int(fill.dst_slot[start + row]), int(seg.src_slot[row]), axis_of[int(dc[row])]
                if a != b:
                    out.setdefault(a, {})[b] = axis
                    out.setdefault(b, {})[a] = axis
        start = stop
    return out


def _is_cube(blocks, neighbours) -> bool:
    """Whether 8 blocks are a 2 x 2 x 2 cube: each has one neighbour among
    them along each axis."""
    members = set(blocks)
    return len(members) == 8 and all(
        sorted(ax for c, ax in neighbours.get(b, {}).items() if c in members) == [0, 1, 2] for b in blocks
    )


def cube_groups(order, neighbours, group: int = HALO_GROUP) -> int:
    """How many of the route's launch groups (``group`` consecutive entries
    of ``order``) are whole octets: 2 x 2 x 2 cubes of face neighbours."""
    order = [int(b) for b in order]
    return sum(_is_cube(order[i : i + group], neighbours) for i in range(0, len(order) - group + 1, group))


def neighbour_order(listed, neighbours, group: int = HALO_GROUP) -> np.ndarray:
    """The halo route's slot list over the blocks ``listed``, ordered so that
    each launch group of ``group`` consecutive entries holds neighbours:
    first every whole octet among them (8 consecutive blocks in block order
    that make a 2 x 2 x 2 cube of face neighbours, as a Morton octet does),
    in block order; then the other blocks, each group grown from the first
    block left by the one that shares the most face weight with it (z faces
    first, :data:`_FACE_WEIGHT`; ties to the lower block), or by the next
    block left where none shares a face (octets are kept whole only for
    groups of 8). A permutation of ``listed``: a block steps on its own, so
    the order changes no output bit, only which CTAs run together."""
    listed = sorted(int(b) for b in listed)
    used: set[int] = set()
    groups = []
    i = 0
    while i + group <= len(listed):
        window = listed[i : i + group]
        if group == 8 and _is_cube(window, neighbours):
            groups.append(window)
            used.update(window)
            i += group
        else:
            i += 1
    rest = [b for b in listed if b not in used]
    inside = set(rest)
    nxt = 0
    while len(used) < len(listed):
        while rest[nxt] in used:
            nxt += 1
        g = [rest[nxt]]
        used.add(g[0])
        score: dict[int, int] = {}
        while len(g) < group and len(used) < len(listed):
            for c, axis in neighbours.get(g[-1], {}).items():
                if c in inside and c not in used:
                    score[c] = score.get(c, 0) + _FACE_WEIGHT[axis]
            for c in [c for c in score if c in used]:
                del score[c]
            if score:
                c = max(score, key=lambda c: (score[c], -c))
            else:
                while rest[nxt] in used:
                    nxt += 1
                c = rest[nxt]
            g.append(c)
            used.add(c)
        groups.append(g)
    return np.asarray([b for g in groups for b in g], dtype=np.int32)


def _int32(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)


# repro: host-ok(build-time lowering and checks over host plan arrays, once per program build)
def _rank_rows(messages, local_plan, level_index, masks, active_levels):
    """One rank's ghost rows of a substep: ``(fills, inbound)``, the local
    plan's merged fill a level and, a level, the inbound message rows as
    :func:`message_tables` takes them (one tuple a scatter segment, in
    (message, segment) order). Asserts on the host that every row targets
    an active level, that no ghost cell is written twice and that no local
    fill reads a written cell."""
    order = [l for l in sorted(level_index, key=level_index.get)]
    nblocks = [masks[l].shape[0] for l in order]
    cells = int(np.prod(tuple(masks[order[0]].shape[1:])))
    fills = lower_halo_fill(local_plan) if local_plan is not None and local_plan.ops else {}
    assert set(fills) <= set(active_levels), (sorted(fills), sorted(active_levels))
    assert {dl for m in messages for dl, *_ in m.scatter} <= set(active_levels)
    _assert_fills_disjoint(fills, level_index, nblocks, cells, messages)
    inbound: dict[int, list] = {}
    for mi, m in enumerate(messages):
        off = 0
        for dl, db, dc, n in m.scatter:
            inbound.setdefault(dl, []).append((mi, db, dc, off, n))
            off += n
    return fills, inbound


def _rank_fills(fills, messages, local_plan, level_index, backend, device):
    """The fill launches of a rank's absorb without a halo stepper factory,
    lowered once: ``(local, inbound)`` where ``local(bufs)`` runs the
    rank-local plan and ``inbound(bufs, msgs)`` writes the received
    payloads, both in place into the pre-step buffers. On ``cuda``,
    fill-kernel launches: the local plan's merged fills from their sources,
    then one ``"values"`` launch a message segment reading its slice of
    the payload; on ``ref``, the plain gather/scatter. Each closure's
    ``segments`` counts the fill launches it makes on ``cuda``."""
    if backend == "cuda":
        tables = [(level_index[l], fill_tables(f, level_index, device)) for l, f in fills.items()]
        segs = tuple(
            tuple(
                (level_index[dl], _int32(db, device), _int32(dc, device), int(off), n)
                for (dl, db, dc, n), off in zip(m.scatter, np.cumsum([0] + [s[3] for s in m.scatter]))
            )
            for m in messages
        )

        def local(bufs):
            for dst, ts in tables:
                for t in ts:
                    lbm_halo_fill(bufs[dst], bufs[t.src], t.kind, t.dst_slot, t.dst_cell, t.src_slot, t.src_cell)

        def inbound(bufs, msgs):
            for mseg, msg in zip(segs, msgs):
                for li, db, dc, off, n in mseg:
                    lbm_halo_fill(bufs[li], msg[off : off + n], "values", db, dc)

        local.segments = sum(len(ts) for _dst, ts in tables)
        inbound.segments = sum(len(mseg) for mseg in segs)
        return local, inbound

    ops_ = _device_plan_ops(local_plan, level_index, device) if fills else []
    segs = tuple(
        tuple((level_index[dl], _index(db, device), _index(dc, device), n) for dl, db, dc, n in m.scatter)
        for m in messages
    )

    def local_ref(bufs):
        _run_plan_ops(ops_, bufs)

    def inbound_ref(bufs, msgs):
        for mseg, msg in zip(segs, msgs):
            off = 0
            for li, db, dc, n in mseg:
                _flat3(bufs[li])[db, :, dc] = msg[off : off + n]
                off += n

    local_ref.segments = inbound_ref.segments = 0
    return local_ref, inbound_ref


def _same_messages(a, b) -> bool:
    """Whether two levels' inbound message rows are the same rows from the
    same payload positions."""
    return len(a) == len(b) and all(
        x[0] == y[0] and x[3:] == y[3:] and np.array_equal(x[1], y[1]) and np.array_equal(x[2], y[2])
        for x, y in zip(a, b)
    )


def shared_halo_steps(factory):
    """Wrap a halo stepper factory ``(level, fill, level_index, messages=())
    -> HaloStep`` so that the calls of one rank's programs (one call a
    pattern and level) whose rows are the same, the same merged local fill
    and the same message rows, share one :class:`HaloStep` and so one map,
    as :func:`make_fused_superstep` shares a level's fill between its
    patterns. Every call must pass the same ``level_index``. The wrapper's
    ``steps()`` lists the distinct steps it built."""
    built: dict[int, list] = {}

    def shared(level, fill, level_index, messages=()):
        for f, m, hstep in built.setdefault(level, []):
            if (f is None) == (fill is None) and (f is None or _same_fill(f, fill)) and _same_messages(m, messages):
                return hstep
        hstep = factory(level, fill, level_index, messages=messages)
        built[level].append((fill, messages, hstep))
        return hstep

    shared.steps = lambda: [h for per in built.values() for _f, _m, h in per]
    return shared


def _rank_halo_steps(factory, fills, inbound, level_index, order) -> dict:
    """A rank's halo step of each active level that has rows, local or
    inbound, from ``factory``."""
    return {
        l: factory(l, fills.get(l), level_index, messages=tuple(inbound.get(l, ())))
        for l in order
        if l in fills or l in inbound
    }


# repro: host-ok(build-time ordering over host plan arrays, once per program build)
def _route_slots(listed, fill, mask, device) -> tuple[np.ndarray, torch.Tensor]:
    """The halo route's slot list over the blocks ``listed`` of a rank
    level: :func:`neighbour_order` over the level's face neighbours (read
    off its merged local fill ``fill``), on the host and on ``device``."""
    order = neighbour_order(listed, face_neighbours(fill, tuple(mask.shape[1:])))
    return order, _int32(order, device)


def make_rank_absorb(
    messages,
    local_plan,
    level_index: dict[int, int],
    *,
    steppers,
    masks,
    active_levels,
    backend: str = "cuda",
    device: torch.device | str = "cuda",
    halo_stepper_factory=None,
):
    """Build one rank's receive+exchange+step side of a sharded substep.

    ``messages`` are the inbound :class:`~..lbm.halo.CompiledRankMessage`
    specs (``dst_rank`` == this rank) in plan order — the caller passes the
    received payloads in the same order; ``local_plan`` is the rank's
    intra-rank :class:`~..lbm.halo.CompiledGhostPlan` (or None);
    ``steppers``/``masks`` map the rank's levels to ``step(f, mask) -> f``
    (:func:`make_stream_collide`) and device mask stacks; ``active_levels``
    is this substep pattern's active set intersected with the rank's levels.

    Returns ``absorb(pdfs: tuple, msgs: tuple) -> tuple``. With
    ``halo_stepper_factory`` (``(level, fill, level_index, messages=()) ->
    HaloStep``, the engines' form, as in the JAX package), the local fill
    and the inbound message rows of each level are merged into one fill,
    folded into the level's halo step (:func:`make_halo_stream_collide`):
    on ``cuda`` one launch of the stencil's halo route a level with rows,
    over the pre-step tuple and the payloads, which writes nothing but its
    output, over a full-length slot list of the level's blocks in
    neighbour order (:func:`neighbour_order`); every other active level is
    the plain stencil. Without it,
    every ghost write of the rank (local fills, then the inbound rows)
    lands in place in the pre-step buffers, then every active level steps.
    Levels step finest first. The caller rebinds the result and never reads
    the tuple it passed in. Its ``fill_segments`` counts the fill launches
    and ``halo_steps`` the halo-route launches a call makes on ``cuda``,
    ``halo`` maps the levels with a halo step to it, and ``slot_lists``
    those levels to their host slot lists (``cuda`` only).
    """
    _check_backend(backend)
    device = torch.device(device)
    order = tuple(sorted(active_levels, reverse=True))  # finest first
    fills, inbound_rows = _rank_rows(messages, local_plan, level_index, masks, active_levels)

    if halo_stepper_factory is not None:
        hsteps = _rank_halo_steps(halo_stepper_factory, fills, inbound_rows, level_index, order)
        # on cuda each halo step runs over a full-length slot list in
        # neighbour order (the route's launch groups hold neighbours)
        lists = {
            l: _route_slots(np.arange(masks[l].shape[0]), fills.get(l), masks[l], device)
            for l in hsteps
            if backend == "cuda"
        }

        def absorb(pdfs, msgs):
            sources = (*pdfs, *msgs)
            bufs = list(pdfs)
            for l in order:
                i = level_index[l]
                h = hsteps.get(l)
                if h is None:
                    bufs[i] = steppers[l](pdfs[i], masks[l])
                elif l in lists:
                    bufs[i] = h.step(pdfs[i], h.fill(sources), slots=lists[l][1], out=torch.empty_like(pdfs[i]))
                else:
                    bufs[i] = h.step(pdfs[i], h.fill(sources))
            return tuple(bufs)

        absorb.fill_segments = 0
        absorb.halo_steps = len(hsteps)
        absorb.halo = hsteps
        absorb.slot_lists = {l: s for l, (s, _t) in lists.items()}
        return absorb

    local, inbound = _rank_fills(fills, messages, local_plan, level_index, backend, device)

    def absorb(pdfs, msgs):
        bufs = list(pdfs)
        local(bufs)
        inbound(bufs, msgs)
        for l in order:
            i = level_index[l]
            bufs[i] = steppers[l](bufs[i], masks[l])
        return tuple(bufs)

    absorb.fill_segments = local.segments + inbound.segments
    absorb.halo_steps = 0
    absorb.halo = {}
    absorb.slot_lists = {}
    return absorb


def make_rank_absorb_split(
    messages,
    local_plan,
    level_index: dict[int, int],
    *,
    steppers,
    masks,
    active_levels,
    backend: str = "cuda",
    device: torch.device | str = "cuda",
    halo_stepper_factory=None,
):
    """Split one rank's substep into an interior and a boundary half so the
    host's message routing overlaps interior stepping.

    *Boundary* blocks are the slots whose ghost layer depends on inbound
    messages (:func:`boundary_slot_sets`); everything else is *interior* —
    an interior block's ghosts are filled entirely by the rank-local plan.
    ``interior(pdfs) -> state`` allocates each active level's output and
    steps the interior slots into it; ``boundary(state, msgs) -> pdfs``
    steps the boundary slots into the same outputs, once the payloads have
    arrived. No sub-stack is gathered or scattered back. With
    ``halo_stepper_factory`` each half is, on ``cuda``, one launch of the
    stencil's halo route a level with rows over its slot list in
    neighbour order (:func:`neighbour_order`), both halves reading one map:
    the interior half's blocks name local rows only (asserted when built),
    so it reads the pre-step tuple alone, and the boundary half reads the
    payloads too. Without it, the interior half
    runs **every** local fill (boundary blocks' local-sourced ghosts
    included) in place on the pre-step buffers before stepping, and the
    boundary half writes the inbound rows before stepping; the halves then
    step through the stencil's slot list. Either way the two halves
    together equal :func:`make_rank_absorb` bit for bit: a block steps on
    its own, and every ghost value it reads is the one the unsplit absorb
    gives it. Arguments as for :func:`make_rank_absorb`; each half's
    ``fill_segments`` and ``halo_steps`` count its fill and halo-route
    launches on ``cuda``, and its ``slot_lists`` maps the levels it steps
    through the route to their host slot lists.
    """
    _check_backend(backend)
    device = torch.device(device)
    order = tuple(sorted(active_levels, reverse=True))
    fills, inbound_rows = _rank_rows(messages, local_plan, level_index, masks, active_levels)
    bnd = boundary_slot_sets(messages, {l: masks[l] for l in order})
    nblocks = {l: masks[l].shape[0] for l in order}
    if halo_stepper_factory is not None:
        hsteps = _rank_halo_steps(halo_stepper_factory, fills, inbound_rows, level_index, order)
        local = inbound = None
    else:
        hsteps = {}
        local, inbound = _rank_fills(fills, messages, local_plan, level_index, backend, device)
    # per level, (interior, boundary): whether the half steps any block of
    # the level, and its slot list (None: every block, no list); on cuda a
    # halo step's lists are in neighbour order
    halves = {}
    lists = ({}, {})
    for l in order:
        b = np.asarray(sorted(bnd.get(l, ())), dtype=np.int32)
        i = np.setdiff1d(np.arange(nblocks[l], dtype=np.int32), b)
        half = []
        for k, idx in enumerate((i, b)):
            if idx.size and l in hsteps and backend == "cuda":
                lists[k][l], slots = _route_slots(idx, fills.get(l), masks[l], device)
            else:
                slots = None if idx.size == nblocks[l] else _int32(idx, device)
            half.append((idx.size > 0, slots))
        halves[l] = tuple(half)
        # repro: host-ok(build-time check over host plan arrays)
        named = np.concatenate([np.asarray(db) for _mi, db, *_r in inbound_rows.get(l, ())] or [np.zeros(0, int)])
        assert not np.isin(i, named).any(), f"an interior block of level {l} names a payload row"

    def step_half(pdfs, sources, outs, which):
        for l in order:
            run, slots = halves[l][which]
            if run:
                i = level_index[l]
                h = hsteps.get(l)
                if h is None:
                    steppers[l](pdfs[i], masks[l], slots=slots, out=outs[i])
                else:
                    h.step(pdfs[i], h.fill(sources), slots=slots, out=outs[i])

    def interior(pdfs):
        bufs = list(pdfs)
        if local is not None:
            local(bufs)
        outs = {level_index[l]: torch.empty_like(bufs[level_index[l]]) for l in order}
        step_half(bufs, tuple(bufs), outs, 0)
        return bufs, outs

    def boundary(state, msgs):
        bufs, outs = state
        if inbound is not None:
            inbound(bufs, msgs)
        step_half(bufs, (*bufs, *msgs), outs, 1)
        return tuple(outs.get(i, b) for i, b in enumerate(bufs))

    interior.fill_segments = 0 if local is None else local.segments
    boundary.fill_segments = 0 if inbound is None else inbound.segments
    # a half launches the route at a level it steps where it reads rows:
    # the interior half its local rows only
    interior.halo_steps = sum(bool(halves[l][0][0] and h.local_rows) for l, h in hsteps.items())
    boundary.halo_steps = sum(bool(halves[l][1][0]) for l in hsteps)
    interior.halo = boundary.halo = hsteps
    interior.slot_lists, boundary.slot_lists = lists
    return interior, boundary


def make_device_superstep(
    *, levels, plans, schedules, steppers, masks, devices, halo_stepper_factories, backend: str = "cuda"
):
    """One coarse step of the ``device_sharded`` mode: every rank's padded
    block stacks on its own device, halo payloads moved device to device.

    The counterpart of the JAX package's ``make_device_superstep`` (one
    ``shard_map`` program over a mesh of ranks), built from this module's
    rank-sharded pieces with no arithmetic of its own. Per substep, in the
    pattern's order (:func:`substep_patterns`), and per ppermute round of
    ``schedules[p]``: every source rank builds its one outbound message with
    :func:`make_rank_emit`, zero-padded to the round's ``num_cells`` rows
    (the wire shape whose pad bytes ``DeviceComm.ppermute`` accounts), and
    the message moves to the destination rank's device in one copy into a
    receive tensor: a peer copy when the ranks sit on two cards, an
    on-device copy when they share one. Then every rank's
    :func:`make_rank_absorb`, built on the rank's own device, steps the
    active levels, finest first, with its ghost cells filled from its local
    sources and from the logical ``m.num_cells`` rows of each inbound
    message: one halo-route launch a level with rows on ``cuda``, over the
    padded stack's blocks in neighbour order, reading each message row from
    the received (padded) payload, and no fill launch. The reference's
    ``lax.switch`` over
    ranks is a loop over ranks here; its ``unroll_limit`` / ``fori_loop``
    have no counterpart, since a coarse step is a plain Python loop over its
    ``2^lmax`` substeps, as in :func:`make_fused_superstep`. Nothing in a
    substep touches the host: no ``Comm`` call, no synchronize, no copy to
    or from the host.

    Stacks are padded to one height a level for every rank
    (:func:`~..lbm.halo.padded_block_counts`); rank-local slot ids address
    the padded stacks unchanged, and no plan reads or writes a pad slot
    (:func:`~..lbm.halo.verify_padded_plan`, asserted by the engine). Every
    rank steps its whole padded stack of each active level: a pad slot
    (all-WALL mask) passes through the stencil unchanged.

    Args:
        levels: refinement levels in use; every rank's buffer tuple holds
            one padded stack a level, ascending.
        plans: pattern index ``p`` -> :class:`~..lbm.halo.CompiledRankHaloPlan`
            for the active set ``{l : l >= lmax - p}``, rank-local slot ids.
        schedules: pattern index ``p`` -> the rounds of
            :func:`~..lbm.halo.schedule_ppermute_rounds` over
            ``plans[p].messages``.
        steppers: level -> ``step(f, mask) -> f`` (:func:`make_stream_collide`).
        masks: rank -> tuple of the rank's padded device mask stacks, one a
            level; closed over, as in every superstep of this module (the
            engine rebuilds the superstep when masks change).
        devices: rank -> the rank's ``torch.device``.
        halo_stepper_factories: rank -> halo stepper factory
            (:func:`make_rank_absorb`'s), built over the rank's padded
            masks on its device; each is shared by the rank's patterns
            (:func:`shared_halo_steps`).
        backend: ``"cuda"`` (the kernels) or ``"ref"``.

    Returns:
        ``superstep(pdfs: dict[rank, tuple]) -> dict[rank, tuple]`` advancing
        one coarse step; it consumes its input tuples. Its ``fill_segments``,
        ``halo_steps`` and ``payload_copies`` attributes count the fill and
        halo-route launches (on ``cuda``) and the message copies of a coarse
        step, and ``halo_step_objects()`` lists the distinct halo steps.
    """
    _check_backend(backend)
    levels = tuple(sorted(levels))
    index = {l: i for i, l in enumerate(levels)}
    lmax = levels[-1]
    ranks = tuple(sorted(devices))
    factories = {r: shared_halo_steps(halo_stepper_factories[r]) for r in ranks}

    def make_branch(p: int):
        active = {l for l in levels if l >= lmax - p}
        rounds = schedules[p]
        # per round, each sender's message and its emit, padded to the round
        sends = [
            [(m, make_rank_emit([m], index, devices[m.src_rank], rows=[rnd.num_cells])) for m in rnd.messages]
            for rnd in rounds
        ]
        inbound = {r: [m for rnd in rounds for m in rnd.messages if m.dst_rank == r] for r in ranks}
        absorbs = {
            r: make_rank_absorb(
                inbound[r],
                plans[p].local.get(r),
                index,
                steppers=steppers,
                masks=dict(zip(levels, masks[r])),
                active_levels=active,
                backend=backend,
                device=devices[r],
                halo_stepper_factory=factories[r],
            )
            for r in ranks
        }

        def branch(pdfs):
            recv = {}
            for rnd in sends:
                for m, emit in rnd:
                    (payload,) = emit(pdfs[m.src_rank])
                    recv[m.key] = payload.to(devices[m.dst_rank], copy=True)
            return {r: absorbs[r](pdfs[r], tuple(recv[m.key] for m in inbound[r])) for r in ranks}

        branch.fill_segments = sum(a.fill_segments for a in absorbs.values())
        branch.halo_steps = sum(a.halo_steps for a in absorbs.values())
        branch.payload_copies = sum(len(rnd) for rnd in sends)
        return branch

    branches = [make_branch(p) for p in range(lmax + 1)]
    pattern = substep_patterns(lmax)

    def superstep(pdfs):
        pdfs = dict(pdfs)
        for p in pattern:
            pdfs = branches[p](pdfs)
        return pdfs

    superstep.fill_segments = sum(branches[p].fill_segments for p in pattern)
    superstep.halo_steps = sum(branches[p].halo_steps for p in pattern)
    superstep.payload_copies = sum(branches[p].payload_copies for p in pattern)
    superstep.halo_step_objects = lambda: [h for f in factories.values() for h in f.steps()]
    return superstep
