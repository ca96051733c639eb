"""Halo-protocol verifier: prove a compiled exchange plan correct without
running a step.

The data-plane contract of the sharded exchange (paper §2/§3.3): every
cross-rank ghost fill travels as exactly one p2p message per (neighboring
rank pair, field); the sender's gather spec and the receiver's scatter spec
describe the *same* payload byte for byte; every ghost cell that has a
neighbor is filled exactly once per exchange; and nothing reads or writes out
of bounds of the per-level arena buffers. The runtime conformance suite
checks this one scenario at a time by stepping; this module proves it for a
built plan by pure index arithmetic:

* **pairwise matching** — every message's rank pair is a process-graph
  neighbor pair, and the reverse message exists (no orphan sends: touching
  blocks see each other's ghosts from both sides);
* **byte symmetry** — ``nbytes == num_cells * lead * itemsize`` and the
  gather rows, scatter rows and declared cell count all agree, so sender and
  receiver walk identical payload layouts;
* **bounds** — every gather/scatter slot exists in the owning rank's slot
  map and every flat cell id lies inside the ghosted block box;
* **direction** — gathers read only *interior* cells (ghost regions are
  clipped to the neighbor's own box), scatters write only *ghost* cells;
* **coverage** — the union of intra-rank copies and incoming message
  scatters equals, exactly and without duplicates, an independent
  recomputation of every block's ghost-ring targets from the
  :func:`~repro.lbm.halo.ghost_regions` geometry oracle.

:func:`sweep_topologies` builds the weak-scaled 3-level benchmark forests
(the 1/4/13-rank conformance topologies) and verifies their compiled plans —
no step execution, no jax — and cross-checks the compiled per-pair byte
counts against the independently built host-plan (:class:`RankHaloPlan`)
patch bytes, so the Table-1 traffic accounting is mode-independent by
construction.
"""

from __future__ import annotations

import numpy as np

from ..core.forest import BlockForest
from ..lbm.halo import (
    CompiledGhostPlan,
    CompiledRankHaloPlan,
    _field_groups,
    _flat_cells,
    _srange,
    ghost_regions,
)
from .findings import Finding

__all__ = [
    "verify_compiled_rank_plan",
    "verify_ghost_plan",
    "rank_slot_map",
    "build_sweep_topology",
    "sweep_topologies",
]


def _fail(path: str, message: str) -> Finding:
    return Finding(
        checker="protocol", severity="error", path=path, line=0, message=message
    )


class _FieldMeta:
    """Per-field geometry: ghosted dims, flat cell count, interior predicate,
    payload row width and itemsize."""

    def __init__(self, spec, fields: tuple[str, ...]):
        self.ghost: dict[str, int] = {}
        self.dims: dict[str, tuple[int, int, int]] = {}
        self.lead: dict[str, int] = {}
        self.itemsize: dict[str, int] = {}
        self.cells = spec.cells
        for sp, names in _field_groups(spec, fields):
            for name in names:
                g = sp.ghost
                self.ghost[name] = g
                self.dims[name] = tuple(c + 2 * g for c in spec.cells)
        from ..core.fields import FieldRegistry

        if isinstance(spec, FieldRegistry):
            for name in fields:
                fs = spec.fields[name]
                self.lead[name] = int(np.prod(fs.shape, dtype=np.int64)) if fs.shape else 1
                self.itemsize[name] = np.dtype(fs.dtype).itemsize
        else:
            for name in fields:
                self.lead[name] = spec.lattice.Q if name == "pdf" else 1
                self.itemsize[name] = np.dtype(spec.dtype).itemsize

    def ncells(self, field: str) -> int:
        dx, dy, dz = self.dims[field]
        return dx * dy * dz

    def interior_mask(self, field: str, cell: np.ndarray) -> np.ndarray:
        """True where the flat ghosted cell id addresses an interior cell."""
        g = self.ghost[field]
        dx, dy, dz = self.dims[field]
        x = cell // (dy * dz)
        y = (cell // dz) % dy
        z = cell % dz
        cx, cy, cz = self.cells
        return (
            (x >= g) & (x < g + cx)
            & (y >= g) & (y < g + cy)
            & (z >= g) & (z < g + cz)
        )


def _expected_targets(
    forest: BlockForest,
    spec,
    fields: tuple[str, ...],
    levels: set[int] | None,
    slot_of,
) -> dict[tuple, list[np.ndarray]]:
    """Independent recomputation of every ghost-ring target from the geometry
    oracle: (owner, field, level) -> flat (slot, cell) encodings."""
    geom = forest.geom
    by_id = {b.bid: b for b in forest.all_blocks()}
    out: dict[tuple, list[np.ndarray]] = {}
    for blk in by_id.values():
        if levels is not None and blk.level not in levels:
            continue
        for nbid in blk.neighbors:
            nb = by_id[nbid]
            for sp, names in _field_groups(spec, fields):
                reg = ghost_regions(geom, sp, blk, nbid, nb.level)
                if reg is None:
                    continue
                target, _ = reg
                dims = tuple(c + 2 * sp.ghost for c in spec.cells)
                cells = _flat_cells(
                    dims, _srange(target[0]), _srange(target[1]), _srange(target[2])
                ).ravel()
                slot = slot_of(blk)
                enc = np.int64(slot) * (dims[0] * dims[1] * dims[2]) + cells
                for name in names:
                    out.setdefault((blk.owner, name, blk.level), []).append(enc)
    return out


def _check_segments(
    path: str,
    meta: _FieldMeta,
    field: str,
    segs,
    slot_sets: dict[int, set[int]],
    *,
    side: str,
    findings: list[Finding],
) -> None:
    """Bounds + direction checks for gather or scatter segments.

    ``segs``: iterables of (level, slot_arr, cell_arr, kindlabel)."""
    D = meta.ncells(field)
    for level, slot, cell, label in segs:
        ok_slots = slot_sets.get(level, set())
        bad = set(np.unique(slot).tolist()) - ok_slots
        if bad:
            findings.append(_fail(
                path,
                f"{side} segment ({field}, level {level}, {label}): slots "
                f"{sorted(bad)} not in the owning rank's level-{level} slot map",
            ))
        if cell.size and (cell.min() < 0 or cell.max() >= D):
            findings.append(_fail(
                path,
                f"{side} segment ({field}, level {level}, {label}): cell ids "
                f"outside [0, {D}) for the ghosted block box {meta.dims[field]}",
            ))
            continue
        interior = meta.interior_mask(field, cell.reshape(-1))
        if side == "gather" and not interior.all():
            findings.append(_fail(
                path,
                f"gather segment ({field}, level {level}, {label}) reads "
                f"{int((~interior).sum())} ghost cells — senders must read "
                "interior data only (ghost regions are clipped to the "
                "neighbor's own box)",
            ))
        if side == "scatter" and interior.any():
            findings.append(_fail(
                path,
                f"scatter segment ({field}, level {level}, {label}) writes "
                f"{int(interior.sum())} interior cells — a halo exchange may "
                "only fill the ghost ring",
            ))


def verify_compiled_rank_plan(
    forest: BlockForest,
    spec,
    plan: CompiledRankHaloPlan,
    rank_slots: dict[int, dict[int, dict[int, int]]],
    *,
    path: str = "<rank-halo-plan>",
) -> list[Finding]:
    """Statically prove a :class:`CompiledRankHaloPlan` implements the halo
    protocol (see module docstring for the checked properties). Returns an
    empty list iff the plan is correct."""
    findings: list[Finding] = []
    meta = _FieldMeta(spec, plan.fields)
    slot_sets = {
        r: {l: set(m.values()) for l, m in per.items()} for r, per in rank_slots.items()
    }
    neighbor_ranks = {r: set(forest.neighbor_ranks(r)) for r in rank_slots}

    msg_keys = {m.key for m in plan.messages}
    for m in plan.messages:
        mpath = f"{path}:msg[{m.src_rank}->{m.dst_rank}:{m.field}]"
        if m.src_rank == m.dst_rank:
            findings.append(_fail(mpath, "self-message: intra-rank fills must be local ops"))
        if m.dst_rank not in neighbor_ranks.get(m.src_rank, set()):
            findings.append(_fail(
                mpath,
                f"rank pair ({m.src_rank}, {m.dst_rank}) is not a process-"
                "graph neighbor pair — stepping traffic must be next-neighbor "
                "only (paper §2)",
            ))
        if (m.dst_rank, m.src_rank, m.field) not in msg_keys:
            findings.append(_fail(
                mpath,
                f"orphan send: no reverse message {m.dst_rank}->{m.src_rank} "
                f"for field '{m.field}' (touching blocks must exchange ghosts "
                "in both directions)",
            ))
        gather_rows = sum(int(np.asarray(cell).shape[0]) for _, _, _, cell in m.gather)
        scatter_rows = sum(n for _, _, _, n in m.scatter)
        scatter_cells = sum(int(cell.size) for _, _, cell, _ in m.scatter)
        if not (gather_rows == scatter_rows == scatter_cells == m.num_cells):
            findings.append(_fail(
                mpath,
                f"payload layout mismatch: gather rows {gather_rows}, scatter "
                f"rows {scatter_rows}/{scatter_cells}, declared num_cells "
                f"{m.num_cells} — sender and receiver would walk different "
                "payloads",
            ))
        expected_bytes = m.num_cells * meta.lead[m.field] * meta.itemsize[m.field]
        if m.nbytes != expected_bytes:
            findings.append(_fail(
                mpath,
                f"byte asymmetry: declared nbytes {m.nbytes} != num_cells * "
                f"lead * itemsize = {expected_bytes} — the fabric accounting "
                "would diverge from the payload",
            ))
        for level, kind, slot, cell in m.gather:
            if kind == "fine" and (cell.ndim != 2 or cell.shape[1] != 8):
                findings.append(_fail(
                    mpath,
                    f"fine gather segment (level {level}) must carry (N, 8) "
                    f"octet indices, got shape {cell.shape}",
                ))
        _check_segments(
            mpath, meta, m.field,
            [(lvl, slot, cell, kind) for lvl, kind, slot, cell in m.gather],
            slot_sets.get(m.src_rank, {}), side="gather", findings=findings,
        )
        _check_segments(
            mpath, meta, m.field,
            [(lvl, slot, cell, "scatter") for lvl, slot, cell, _ in m.scatter],
            slot_sets.get(m.dst_rank, {}), side="scatter", findings=findings,
        )

    for rank, local in plan.local.items():
        lpath = f"{path}:local[rank {rank}]"
        for op in local.ops:
            _check_segments(
                lpath, meta, op.field,
                [(op.src_level, op.src_slot, op.src_cell, op.kind)],
                slot_sets.get(rank, {}), side="gather", findings=findings,
            )
            _check_segments(
                lpath, meta, op.field,
                [(op.dst_level, op.dst_slot, op.dst_cell, op.kind)],
                slot_sets.get(rank, {}), side="scatter", findings=findings,
            )

    # coverage: local scatters + incoming message scatters == the geometry
    # oracle's ghost-ring targets, exactly once each
    levels = None if plan.levels is None else set(plan.levels)
    expected = _expected_targets(
        forest, spec, plan.fields, levels,
        lambda blk: rank_slots[blk.owner][blk.level][blk.bid],
    )
    actual: dict[tuple, list[np.ndarray]] = {}

    def add_actual(rank: int, field: str, level: int, slot: np.ndarray, cell: np.ndarray):
        enc = slot.astype(np.int64) * meta.ncells(field) + cell.astype(np.int64)
        actual.setdefault((rank, field, level), []).append(enc)

    for rank, local in plan.local.items():
        for op in local.ops:
            add_actual(rank, op.field, op.dst_level, op.dst_slot, op.dst_cell)
    for m in plan.messages:
        for level, slot, cell, _ in m.scatter:
            add_actual(m.dst_rank, m.field, level, slot, cell)

    for key in sorted(set(expected) | set(actual)):
        rank, field, level = key
        exp = np.sort(np.concatenate(expected.get(key, [np.empty(0, np.int64)])))
        act = np.sort(np.concatenate(actual.get(key, [np.empty(0, np.int64)])))
        if exp.shape == act.shape and np.array_equal(exp, act):
            continue
        kpath = f"{path}:coverage[rank {rank}, {field}, level {level}]"
        missing = np.setdiff1d(exp, act).size
        extra = np.setdiff1d(act, exp).size
        dupes = act.size - np.unique(act).size
        findings.append(_fail(
            kpath,
            f"ghost-ring coverage mismatch: {missing} expected ghost cells "
            f"never filled, {extra} writes outside the expected ring, "
            f"{dupes} duplicate writes (expected {exp.size}, got {act.size})",
        ))
    return findings


def verify_ghost_plan(
    forest: BlockForest,
    spec,
    plan: CompiledGhostPlan,
    slots: dict[int, dict[int, int]],
    *,
    path: str = "<ghost-plan>",
) -> list[Finding]:
    """Single-arena variant (the fused engine's intra-rank plan): bounds,
    gather/scatter direction, and exact ghost-ring coverage."""
    findings: list[Finding] = []
    meta = _FieldMeta(spec, plan.fields)
    slot_sets = {l: set(m.values()) for l, m in slots.items()}
    for op in plan.ops:
        _check_segments(
            path, meta, op.field,
            [(op.src_level, op.src_slot, op.src_cell, op.kind)],
            slot_sets, side="gather", findings=findings,
        )
        _check_segments(
            path, meta, op.field,
            [(op.dst_level, op.dst_slot, op.dst_cell, op.kind)],
            slot_sets, side="scatter", findings=findings,
        )
    levels = None if plan.levels is None else set(plan.levels)
    expected = _expected_targets(
        forest, spec, plan.fields, levels,
        lambda blk: slots[blk.level][blk.bid],
    )
    actual: dict[tuple, list[np.ndarray]] = {}
    for op in plan.ops:
        enc = op.dst_slot.astype(np.int64) * meta.ncells(op.field) + op.dst_cell.astype(np.int64)
        actual.setdefault((None, op.field, op.dst_level), []).append(enc)
    expected = {(None, f, l): v for (_, f, l), v in expected.items()}
    for key in sorted(set(expected) | set(actual), key=str):
        _, field, level = key
        exp = np.sort(np.concatenate(expected.get(key, [np.empty(0, np.int64)])))
        act = np.sort(np.concatenate(actual.get(key, [np.empty(0, np.int64)])))
        if not (exp.shape == act.shape and np.array_equal(exp, act)):
            findings.append(_fail(
                f"{path}:coverage[{field}, level {level}]",
                f"ghost-ring coverage mismatch: expected {exp.size} target "
                f"cells, plan scatters {act.size} "
                f"({np.setdiff1d(exp, act).size} missing, "
                f"{np.setdiff1d(act, exp).size} extra)",
            ))
    return findings


# -- topology sweep ----------------------------------------------------------------


def rank_slot_map(forest: BlockForest) -> dict[int, dict[int, dict[int, int]]]:
    """Deterministic rank -> level -> bid -> slot assignment (sorted bids),
    the shape :func:`~repro.lbm.halo.compile_rank_halo_plan` consumes."""
    per: dict[int, dict[int, list[int]]] = {}
    for b in forest.all_blocks():
        per.setdefault(b.owner, {}).setdefault(b.level, []).append(b.bid)
    return {
        r: {l: {bid: i for i, bid in enumerate(sorted(bids))} for l, bids in levels.items()}
        for r, levels in per.items()
    }


def build_sweep_topology(nranks: int, *, blocks_per_rank: int = 8) -> BlockForest:
    """The weak-scaled 3-level benchmark forest (mirrors
    ``benchmarks.scenario.build_scenario``), built through the real AMR
    pipeline — topology only, no field data, no stepping."""
    from ..core import (
        AMRPipeline,
        BlockDataRegistry,
        Comm,
        ForestGeometry,
        SFCBalancer,
        make_uniform_forest,
    )

    target_roots = max(1, nranks * blocks_per_rank // 16)
    rx = max(1, int(round(target_roots ** (1 / 3))))
    ry = max(1, int(round((target_roots / rx) ** 0.5)))
    rz = max(1, target_roots // (rx * ry))
    geom = ForestGeometry(root_grid=(rx, ry, rz), max_level=10)
    forest = make_uniform_forest(geom, nranks, level=0)
    comm = Comm(nranks)
    pipe = AMRPipeline(balancer=SFCBalancer(), registry=BlockDataRegistry.trivial())

    def refine_corner(rank, blocks):
        out = {}
        for bid, blk in blocks.items():
            x0, _, _, _, _, z1 = geom.aabb(bid)
            full = 1 << geom.max_level
            if z1 >= rz * full and x0 < (rx * full) // 2 and blk.level < 2:
                out[bid] = blk.level + 1
        return out

    forest, _ = pipe.run_cycle(forest, comm, refine_corner)
    forest, _ = pipe.run_cycle(forest, comm, refine_corner)
    return forest


def sweep_topologies(
    ranks: tuple[int, ...] = (1, 4, 13),
    *,
    cells: tuple[int, int, int] = (8, 8, 8),
    cross_check_host_bytes: bool = True,
) -> list[Finding]:
    """Verify the compiled rank-halo plan of each sweep topology; optionally
    cross-check compiled per-pair byte counts against the independently built
    host plan's patch bytes (``RankHaloPlan.nbytes``)."""
    from ..lbm.grid import LBMBlockSpec, make_lbm_fields
    from ..lbm.halo import build_rank_halo_plan, compile_rank_halo_plan

    findings: list[Finding] = []
    fields = ("pdf", "mask")
    for n in ranks:
        tpath = f"<topology:{n}ranks>"
        forest = build_sweep_topology(n)
        spec = LBMBlockSpec(cells=cells, ghost=1)
        registry = make_lbm_fields(spec)
        rank_slots = rank_slot_map(forest)
        plan = compile_rank_halo_plan(forest, registry, rank_slots, fields=fields)
        findings.extend(
            verify_compiled_rank_plan(forest, registry, plan, rank_slots, path=tpath)
        )
        if n > 1 and not plan.messages:
            findings.append(_fail(
                tpath, "multi-rank topology produced no cross-rank messages"
            ))
        if cross_check_host_bytes:
            for b in forest.all_blocks():
                b.data["pdf"] = np.zeros(spec.pdf_shape, dtype=spec.dtype)
                b.data["mask"] = np.zeros(spec.mask_shape, dtype=np.int32)
            host = build_rank_halo_plan(forest, registry, fields=fields)
            compiled_pair_bytes: dict[tuple[int, int], int] = {}
            for m in plan.messages:
                key = (m.src_rank, m.dst_rank)
                compiled_pair_bytes[key] = compiled_pair_bytes.get(key, 0) + m.nbytes
            if compiled_pair_bytes != dict(host.nbytes):
                findings.append(_fail(
                    tpath,
                    "compiled per-pair byte counts diverge from the host "
                    f"plan's patch bytes: compiled={compiled_pair_bytes} "
                    f"host={dict(host.nbytes)} — Table-1 traffic would be "
                    "mode-dependent",
                ))
    return findings
