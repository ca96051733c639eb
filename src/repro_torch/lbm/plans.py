"""The supersteps' ghost plans from one compile of the whole forest.

A superstep needs the compiled ghost plan of every activity pattern ``p``,
whose targets are the levels ``l >= lmax - p``. The copied
:func:`~.halo.compile_ghost_plan` walks every (block, neighbour) pair of its
target levels and batches the rows per (field, destination level, source
level, kind) in block order; sources are never restricted, so a destination
level's ops do not depend on which other levels are targets. Each pattern's
plan is therefore the whole forest's plan with the ops of its levels kept,
equal op for op to the copy's compile of those levels (held by
``tests/test_torch_cavity_scale.py``). The fused engine compiles it once an
AMR event, for its host fill and for the next superstep's patterns: the
build after the card-scale cavity's second event went from 55 s to under
6 s (PERF.md section 6).

The rank-sharded plans (:func:`~.halo.compile_rank_halo_plan`) cut the same
way. A rank's local ops are batched as the single-arena ops are. A rank
pair's message packs one gather segment a (source level, kind) in sorted
order, and the kind fixes the destination level (``same`` keeps it,
``fine`` is one coarser, ``coarse`` one finer; the copy asserts one
destination level a segment), so a pattern's message is the whole message
with the segments of its target levels kept, in the same order, and its
bytes are those segments' rows. A message left with no segment, and a
rank's local plan left with no op, drop out, as the copy never makes them.
Held message for message by ``tests/test_torch_sharded_scale.py``. The
post-event host fill of the sharded engines runs through the same compile
(:func:`run_rank_plan_on_host`): the local ops in place on each rank's host
stacks, one payload a rank pair through the ``Comm`` fabric with the copy's
bytes.

Both whole-forest compiles walk the pairs as the copy does, in its order,
but compute each distinct region once (:class:`_Regions`): a region is a
function of the pair's levels and relative corner, so a forest of equal
blocks has a few hundred of them where the copy recomputes one a pair (the
rank plan of 1,476 blocks went from 2.8 s to 0.19 s on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from .halo import (
    CompiledGhostOp,
    CompiledGhostPlan,
    CompiledRankHaloPlan,
    CompiledRankMessage,
    _field_groups,
    _lower_region_cells,
    _traced_plan,
    ghost_regions,
)

__all__ = [
    "compile_forest_plan",
    "pattern_plans",
    "compile_rank_forest_plan",
    "rank_pattern_plans",
    "run_rank_plan_on_host",
]


_FIELDS = ("pdf",)  # the plans' one field, as the engines compile it


def _targets(levels) -> dict[int, frozenset[int]]:
    """Pattern ``p`` (0..lmax) -> its target levels ``{l >= lmax - p}``."""
    levels = sorted(levels)
    lmax = levels[-1]
    return {p: frozenset(l for l in levels if l >= lmax - p) for p in range(lmax + 1)}


class _Regions:
    """The copy's :func:`~.halo.ghost_regions` of a (block, neighbour) pair,
    lowered by its ``_lower_region_cells``: ``(kind, target cells, source
    cells)`` or None. The geometry is a function of the pair's levels and
    the neighbour's corner relative to the block's (every quantity the copy
    computes is a difference of box corners), so it is computed once a
    distinct (spec, levels, offset) and shared: a forest of equal blocks
    has a few hundred such pairs, where the copy recomputes each of its
    hundreds of thousands. The cell arrays are shared between entries and
    only ever read."""

    def __init__(self, geom) -> None:
        self.geom = geom
        self.boxes: dict[int, tuple] = {}
        self.memo: dict[tuple, tuple | None] = {}

    def box(self, bid: int) -> tuple:
        b = self.boxes.get(bid)
        if b is None:
            b = self.boxes[bid] = self.geom.aabb(bid)
        return b

    def __call__(self, sp, blk, nb):
        b, n = self.box(blk.bid), self.box(nb.bid)
        key = (tuple(sp.cells), sp.ghost, blk.level, nb.level, n[0] - b[0], n[1] - b[1], n[2] - b[2])
        if key not in self.memo:
            reg = ghost_regions(self.geom, sp, blk, nb.bid, nb.level)
            if reg is None:
                self.memo[key] = None
            else:
                target, (kind, src) = reg
                self.memo[key] = (kind, *_lower_region_cells(sp, target, kind, src))
        return self.memo[key]


def _rows(entries) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``(dst_slot, dst_cell, src_slot, src_cell)`` of a batch's entries
    ((target slot, source slot, target cells, source cells), in order) as
    the copy concatenates them: int32 slots repeated a row (a fine row's
    source slot over its octet), int32 cells."""
    t_slots, s_slots, tgt, src = zip(*entries)
    counts = [t.size for t in tgt]
    src_cell = np.concatenate(src).astype(np.int32)
    src_slot = np.repeat(np.asarray(s_slots, np.int32), counts)
    if src_cell.ndim == 2:
        src_slot = np.repeat(src_slot[:, None], src_cell.shape[1], axis=1)
    return np.repeat(np.asarray(t_slots, np.int32), counts), np.concatenate(tgt).astype(np.int32), src_slot, src_cell


def _pairs(forest, fields, levels):
    """The copy's walk for the pdf field: every (block of ``levels``,
    neighbour) with a ghost region, in its order, as (block, neighbour,
    field names, (kind, target cells, source cells))."""
    groups = _field_groups(fields, _FIELDS)
    regions = _Regions(forest.geom)
    by_id = {b.bid: b for b in forest.all_blocks()}
    for blk in by_id.values():
        if blk.level not in levels:
            continue
        for nbid in blk.neighbors:
            nb = by_id[nbid]
            for sp, group in groups:
                reg = regions(sp, blk, nb)
                if reg is not None:
                    yield blk, nb, group, reg


@_traced_plan("compile_forest_plan")
def compile_forest_plan(forest, fields, slots: dict, levels) -> CompiledGhostPlan:
    """The pdf ghost plan whose targets are all of ``levels`` (the
    levels in use), addressed by ``slots`` (level -> bid -> slot): equal op
    for op to the copy's :func:`~.halo.compile_ghost_plan` of those levels,
    each distinct region computed once (:class:`_Regions`)."""
    levels = frozenset(levels)
    acc: dict[tuple, list] = {}
    for blk, nb, group, (kind, tgt, src) in _pairs(forest, fields, levels):
        entry = (slots[blk.level][blk.bid], slots[nb.level][nb.bid], tgt, src)
        for name in group:
            acc.setdefault((name, blk.level, nb.level, kind), []).append(entry)
    ops = tuple(
        CompiledGhostOp(name, dl, sl, kind, *_rows(entries)) for (name, dl, sl, kind), entries in sorted(acc.items())
    )
    return CompiledGhostPlan(fields=_FIELDS, levels=levels, ops=ops)


def pattern_plans(full: CompiledGhostPlan, levels) -> dict[int, CompiledGhostPlan]:
    """Pattern ``p`` (0..lmax) -> the plan of targets ``{l >= lmax - p}``,
    cut from ``full`` (:func:`compile_forest_plan` of ``levels``)."""
    return {
        p: CompiledGhostPlan(fields=full.fields, levels=targets,
                             ops=tuple(op for op in full.ops if op.dst_level in targets))
        for p, targets in _targets(levels).items()
    }


@_traced_plan("compile_rank_forest_plan")
def compile_rank_forest_plan(forest, fields, rank_slots: dict, levels) -> CompiledRankHaloPlan:
    """The rank-sharded pdf plan whose targets are all of
    ``levels``, addressed by ``rank_slots`` (rank -> level -> bid -> slot):
    equal op for op and message for message to the copy's
    :func:`~.halo.compile_rank_halo_plan` of those levels, each distinct
    region computed once (:class:`_Regions`). ``fields`` is the
    simulation's :class:`~..core.fields.FieldRegistry`."""
    levels = frozenset(levels)
    local_acc: dict[int, dict[tuple, list]] = {}
    msg_acc: dict[tuple, dict[tuple, list]] = {}
    for blk, nb, group, (kind, tgt, src) in _pairs(forest, fields, levels):
        entry = (rank_slots[blk.owner][blk.level][blk.bid], rank_slots[nb.owner][nb.level][nb.bid], tgt, src)
        for name in group:
            if nb.owner == blk.owner:
                local_acc.setdefault(blk.owner, {}).setdefault((name, blk.level, nb.level, kind), []).append(entry)
            else:  # data flows owner(neighbour) -> owner(block)
                msg_acc.setdefault((nb.owner, blk.owner, name), {}).setdefault((nb.level, kind), []).append(
                    (*entry, blk.level))
    local = {
        rank: CompiledGhostPlan(fields=_FIELDS, levels=levels, ops=tuple(
            CompiledGhostOp(name, dl, sl, kind, *_rows(entries)) for (name, dl, sl, kind), entries in sorted(acc.items())
        ))
        for rank, acc in local_acc.items()
    }
    messages = []
    for (src_rank, dst_rank, name), seg_map in sorted(msg_acc.items()):
        fs = fields.fields[name]
        row_bytes = int(np.prod(fs.shape, dtype=np.int64)) * np.dtype(fs.dtype).itemsize
        gather, scatter, total = [], [], 0
        for (src_level, kind), entries in sorted(seg_map.items()):
            dst_levels = {e[4] for e in entries}
            assert len(dst_levels) == 1, (src_rank, dst_rank, name, dst_levels)
            d_slot, d_cell, g_slot, g_cell = _rows([e[:4] for e in entries])
            gather.append((src_level, kind, g_slot, g_cell))
            scatter.append((dst_levels.pop(), d_slot, d_cell, int(d_cell.size)))
            total += int(d_cell.size)
        messages.append(CompiledRankMessage(src_rank=src_rank, dst_rank=dst_rank, field=name, nbytes=total * row_bytes,
                                            num_cells=total, gather=tuple(gather), scatter=tuple(scatter)))
    return CompiledRankHaloPlan(fields=_FIELDS, levels=levels, local=local, messages=tuple(messages))


def _cut_message(m: CompiledRankMessage, targets: frozenset[int]) -> CompiledRankMessage | None:
    keep = [k for k, (dl, *_r) in enumerate(m.scatter) if dl in targets]
    if not keep:
        return None
    cells = sum(m.scatter[k][3] for k in keep)
    return CompiledRankMessage(
        src_rank=m.src_rank, dst_rank=m.dst_rank, field=m.field, nbytes=m.nbytes // m.num_cells * cells,
        num_cells=cells, gather=tuple(m.gather[k] for k in keep), scatter=tuple(m.scatter[k] for k in keep),
    )


def rank_pattern_plans(full: CompiledRankHaloPlan, levels) -> dict[int, CompiledRankHaloPlan]:
    """Pattern ``p`` (0..lmax) -> the rank plan of targets ``{l >= lmax -
    p}``, cut from ``full`` (:func:`compile_rank_forest_plan` of
    ``levels``)."""
    out = {}
    for p, targets in _targets(levels).items():
        local = {}
        for r, plan in full.local.items():
            ops = tuple(op for op in plan.ops if op.dst_level in targets)
            if ops:
                local[r] = CompiledGhostPlan(fields=plan.fields, levels=targets, ops=ops)
        messages = tuple(c for c in (_cut_message(m, targets) for m in full.messages) if c is not None)
        out[p] = CompiledRankHaloPlan(fields=full.fields, levels=targets, local=local, messages=messages)
    return out


def run_rank_plan_on_host(plan: CompiledRankHaloPlan, bufs: dict[int, dict[int, np.ndarray]], comm) -> None:
    """Run a compiled rank plan in place on the ranks' host stacks (``bufs``:
    rank -> level -> array): every rank's local ops, then one payload a
    rank pair, gathered (and resampled) from the sender's stacks, sent
    through ``comm`` with its ``nbytes`` and written into the receiver's
    ghost cells; bitwise the copied region-list fill
    (:func:`~.halo.fill_ghost_layers_sharded`: targets are ghost cells,
    sources interior ones), with the same messages and bytes on the
    fabric. The gathers and writes are the fused engine's host fill's
    (:func:`~..kernels.lbm_collide.ops.run_compiled_ghost_plan`), on
    ``torch.from_numpy`` views of the stacks."""
    from ..kernels.lbm_collide.ops import _flat3, _gather_vals, run_compiled_ghost_plan

    views = {r: {l: torch.from_numpy(a) for l, a in per.items()} for r, per in bufs.items()}
    for r, local in plan.local.items():
        run_compiled_ghost_plan(local, views[r])
    if not plan.messages:
        return
    for m in plan.messages:
        src = views[m.src_rank]
        parts = [_gather_vals(src[sl], kind, torch.from_numpy(sb.astype(np.int64)), torch.from_numpy(sc.astype(np.int64)))
                 for sl, kind, sb, sc in m.gather]
        comm.send(m.src_rank, m.dst_rank, "halo", (m.key, torch.cat(parts)), nbytes=m.nbytes)
    by_key = {m.key: m for m in plan.messages}
    for _dst, msgs in comm.exchange().items():
        for _tag, (key, payload) in msgs:
            m = by_key[key]
            off = 0
            for dl, db, dc, n in m.scatter:
                _flat3(views[m.dst_rank][dl])[torch.from_numpy(db.astype(np.int64)), :,
                                              torch.from_numpy(dc.astype(np.int64))] = payload[off : off + n]
                off += n
