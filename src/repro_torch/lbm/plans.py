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
"""

from __future__ import annotations

from .halo import CompiledGhostPlan, compile_ghost_plan

__all__ = ["compile_forest_plan", "pattern_plans"]


def compile_forest_plan(forest, fields, slots: dict, levels) -> CompiledGhostPlan:
    """The pdf ghost plan whose targets are all of ``levels`` (the levels in
    use, ascending), addressed by ``slots`` (level -> bid -> slot)."""
    return compile_ghost_plan(forest, fields, slots, fields=("pdf",), levels=set(levels))


def pattern_plans(full: CompiledGhostPlan, levels) -> dict[int, CompiledGhostPlan]:
    """Pattern ``p`` (0..lmax) -> the plan of targets ``{l >= lmax - p}``,
    cut from ``full`` (:func:`compile_forest_plan` of ``levels``)."""
    levels = sorted(levels)
    lmax = levels[-1]
    out = {}
    for p in range(lmax + 1):
        targets = frozenset(l for l in levels if l >= lmax - p)
        out[p] = CompiledGhostPlan(
            fields=full.fields, levels=targets, ops=tuple(op for op in full.ops if op.dst_level in targets)
        )
    return out
