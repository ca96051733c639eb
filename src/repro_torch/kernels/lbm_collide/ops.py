"""Stepping entry points around the stream+collide kernels.

Dispatches between the hand-written CUDA kernels (``backend="cuda"``, the
default; on a CPU tensor they take their plain PyTorch versions) and the
plain PyTorch versions chosen outright (``backend="ref"``). All
simulation-constant parameters (lattice, omega, wall velocity, collision
model) are closed over, so a step takes only the block stack and the mask.

The compiled superstep implements the halo-in-tile data plane: every active
level's ghost fill is merged into one fill (:func:`~..lbm.halo.lower_halo_fill`)
and handed to the halo-aware kernel together with the stencil
(:func:`make_halo_stream_collide`). The gathers and scatters of the exchange
are PyTorch index ops on the device; a coarse step is a plain Python loop
over its ``2^lmax`` substeps with no host transfer in it.
"""

from __future__ import annotations

import numpy as np
import torch

from ...lbm.halo import lower_halo_fill
from ...lbm.lattice import D3Q19, Lattice
from .lbm_collide import lbm_stream_collide, lbm_stream_collide_halo
from .ref import (
    _np_dtype,
    collision_coeffs,
    precompute_stream_masks,
    stream_collide_halo_ref,
    stream_collide_ref,
)

__all__ = [
    "make_stream_collide",
    "make_arena_stream_collide",
    "make_halo_stream_collide",
    "apply_compiled_ghost_plan",
    "make_fused_superstep",
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
    """Build ``step(f_blocks, mask_blocks) -> f_blocks`` on (B, Q, X, Y, Z)
    stacks; the step runs on whichever device its tensors lie on."""
    _check_backend(backend)
    kw = dict(omega=omega, lattice=lattice, u_wall=u_wall, collision=collision)
    if backend == "cuda":

        def step(f: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
            return lbm_stream_collide(f, mask, **kw)

    else:

        def step(f: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
            return stream_collide_ref(f, mask, **kw)

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
    """Repack a flat merged fill into the per-block padded slab layout the
    halo-aware kernel consumes.

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


def _index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def make_halo_stream_collide(
    dst_slot: np.ndarray,
    dst_cell: np.ndarray,
    *,
    mask: np.ndarray,
    omega: float,
    lattice: Lattice = D3Q19,
    u_wall: tuple[float, float, float] = (0.0, 0.0, 0.0),
    collision: str = "bgk",
    magic: float = 3.0 / 16.0,
    backend: str = "cuda",
    device: torch.device | str = "cuda",
):
    """Build a halo-aware ``step(f, vals) -> f`` for one level's block stack:
    the ghost fill targeting (``dst_slot``, ``dst_cell``) and the
    stream+collide stencil run as one unit.

    ``vals`` is the ``(N, Q)`` concatenated fill values (gathered by the
    enclosing superstep from pre-step buffers, in the merged fill's segment
    order). On the ``cuda`` backend the values are repacked into the padded
    per-block slab (:func:`_pad_fill_layout`) and the halo kernel fills and
    steps; on the ``ref`` backend the fill is one merged scatter into a copy
    of ``f`` feeding the stencil, with the streaming selectors precomputed on
    the host (:func:`~.ref.precompute_stream_masks`).

    ``mask`` is the level's host ``(B, X, Y, Z)`` cell-type stack, closed
    over as a constant (programs are rebuilt on mask refresh / AMR events).
    """
    _check_backend(backend)
    mask = np.asarray(mask)
    device = torch.device(device)
    nblocks = mask.shape[0]
    dims = mask.shape[1:]
    assert dst_cell.size > 0, "use make_stream_collide when there is no fill"
    kw = dict(omega=omega, lattice=lattice, u_wall=u_wall, collision=collision, magic=magic)

    if backend == "cuda":
        entry, cell, valid = _pad_fill_layout(dst_slot, dst_cell, nblocks, dims)
        entry_t = _index(entry, device)
        cell_t = torch.as_tensor(cell, device=device)
        valid_t = torch.as_tensor(valid, device=device)
        mask_t = torch.as_tensor(mask, device=device)

        def step(f: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
            hv = vals[entry_t]  # (B, P, Q) padded per-block slabs
            return lbm_stream_collide_halo(f, mask_t, hv, cell_t, valid_t, **kw)

    else:
        pm = {
            k: torch.as_tensor(v, device=device)
            for k, v in precompute_stream_masks(mask, lattice).items()
        }
        db = _index(dst_slot, device)
        dc = _index(dst_cell, device)

        def step(f: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
            coeffs = collision_coeffs(**kw, dtype=_np_dtype(f.dtype))
            return stream_collide_halo_ref(
                f, vals, db, dc, coeffs, premask=pm, lattice=lattice, collision=collision
            )

    return step


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


def _concat_vals(bufs, gathers) -> torch.Tensor:
    """Concatenate gathered segment values in merged-fill order."""
    parts = [_gather_vals(bufs[si], kind, sb, sc) for si, kind, sb, sc in gathers]
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


def make_fused_superstep(*, levels, plans, steppers, masks, halo_stepper_factory):
    """One full coarse step — the whole ``2^lmax`` substep cycle with
    interleaved ghost exchange — as one device-resident function.

    Per substep ``s`` the active level set is ``{l : s % 2^(lmax-l) == 0}``,
    which depends only on the number of trailing zeros of ``s``; there are
    therefore just ``lmax+1`` distinct *activity patterns*, each built once
    as a branch. A branch runs the halo-in-tile schedule: every active
    level's ghost fill is merged into one fill
    (:func:`~..lbm.halo.lower_halo_fill`), all fill values are gathered up
    front from the pre-step buffers (sources are interior cells, disjoint
    from every fill target, so this equals the sequential per-op schedule
    bit for bit), and each level then steps through its fused fill+stencil
    (which on the card writes the fill into its input's ghost ring in
    place — safe, since every gather already happened). The substeps run as
    a plain Python loop; nothing touches the host.

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
        halo_stepper_factory: ``(level, dst_slot, dst_cell) -> step(f, vals)``
            builder (see :func:`make_halo_stream_collide`).

    Returns:
        ``superstep(pdfs: tuple) -> tuple`` advancing one coarse step;
        ``pdfs`` holds one (B, Q, X, Y, Z) tensor per level, ascending.
    """
    levels = tuple(sorted(levels))
    index = {l: i for i, l in enumerate(levels)}
    lmax = levels[-1]
    nsub = 1 << lmax
    masks_t = tuple(masks[l] for l in levels)
    device = masks_t[0].device

    def make_branch(p: int):
        active = tuple(sorted((l for l in levels if l >= lmax - p), reverse=True))
        fills = lower_halo_fill(plans[p])
        assert set(fills) <= set(active), (sorted(fills), active)
        gathers = {l: _lower_fill_gathers(f, index, device) for l, f in fills.items()}
        hsteps = {
            l: halo_stepper_factory(l, f.dst_slot, f.dst_cell)
            for l, f in fills.items()
        }

        def branch(pdfs):
            bufs = list(pdfs)
            # all fill values gather from the pre-step buffers (every source
            # is an interior cell; every target a ghost cell — disjoint)
            vals = {l: _concat_vals(bufs, gathers[l]) for l in fills}
            for l in active:  # finest first
                i = index[l]
                if l in fills:
                    bufs[i] = hsteps[l](bufs[i], vals[l])
                else:
                    bufs[i] = steppers[l](bufs[i], masks_t[i])
            return tuple(bufs)

        return branch

    branches = [make_branch(p) for p in range(lmax + 1)]
    # pattern of substep s = trailing zeros of s (s=0 activates everything)
    pattern = [
        lmax if s == 0 else min((s & -s).bit_length() - 1, lmax) for s in range(nsub)
    ]

    def superstep(pdfs):
        pdfs = tuple(pdfs)
        for s in range(nsub):
            pdfs = branches[pattern[s]](pdfs)
        return pdfs

    return superstep
