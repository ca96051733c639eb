"""Ghost-layer exchange between blocks (data plane).

For every block/neighbor pair the region to fill is the intersection of the
block's ghost-extended box with the neighbor's box, computed exactly in
integer fine units (the octree geometry guarantees all box corners are
multiples of the coarser cell size when the per-block cell count is even).

Level transitions use the volumetric scheme of [54]/[16] (paper §3.3):

* fine -> coarse ghost ("coalescence"): average 2x2x2 fine cells;
* coarse -> fine ghost ("explosion"): replicate the covering coarse cell.

Two execution models share the same region geometry:

* **host-plane** (:func:`fill_ghost_layers`): neighbor data is read directly
  regardless of ownership — the seed behavior, kept as the reference;
* **rank-sharded** (:func:`fill_ghost_layers_sharded`): intra-rank faces are
  in-place copies, cross-rank faces travel as point-to-point messages over
  the :class:`~repro.core.comm.Comm` fabric — the standard nonuniform-LBM
  communication of [57]. Resampling happens on the *sender* (restrict before
  send, explode before send), so each message carries exactly the ghost
  region it fills, all patches for one rank pair are batched into a single
  message per exchange, and only process-graph neighbors ever communicate.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.blockid import ForestGeometry
from ..core.comm import Comm
from ..core.fields import FieldRegistry
from ..core.forest import Block, BlockForest
from ..telemetry import get_tracer
from .grid import LBMBlockSpec

_TR = get_tracer()


def _traced_plan(name: str):
    """Record plan build/compile work as a ``halo.plan`` span (these run at
    adoption and AMR events, never per substep — the span makes replanning
    cost visible next to the compile events it usually precedes)."""

    def deco(fn):
        def wrapper(*args, **kwargs):
            if not _TR.enabled:
                return fn(*args, **kwargs)
            with _TR.span(name, cat="halo.plan"):
                return fn(*args, **kwargs)

        wrapper.__name__ = fn.__name__
        wrapper.__doc__ = fn.__doc__
        wrapper.__wrapped__ = fn
        return wrapper

    return deco

__all__ = [
    "fill_ghost_layers",
    "fill_ghost_layers_sharded",
    "ghost_regions",
    "build_ghost_plan",
    "run_ghost_plan",
    "RankHaloPlan",
    "build_rank_halo_plan",
    "run_rank_halo_plan",
    "CompiledGhostOp",
    "CompiledGhostPlan",
    "compile_ghost_plan",
    "HaloFillSegment",
    "LevelHaloFill",
    "lower_halo_fill",
    "CompiledRankMessage",
    "CompiledRankHaloPlan",
    "compile_rank_halo_plan",
]

# 2x2x2 coalescence offsets in the canonical (lexicographic) order; the host
# extractor and the compiled plan both sum in exactly this sequence so their
# float32 results are bitwise identical.
_OCTET_OFFSETS: tuple[tuple[int, int, int], ...] = tuple(
    (dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)
)


def _boxes(geom: ForestGeometry, bid: int) -> tuple[np.ndarray, np.ndarray]:
    box = geom.aabb(bid)
    return np.asarray(box[:3], dtype=np.int64), np.asarray(box[3:], dtype=np.int64)


def ghost_regions(
    geom: ForestGeometry,
    spec: LBMBlockSpec,
    blk: Block,
    nbid: int,
    nlevel: int,
):
    """Compute (target slices, source spec) for filling blk's ghosts from
    neighbor ``nbid``. Returns None if the ghost-extended boxes do not
    overlap (cannot happen for true neighbors)."""
    g = spec.ghost
    ncells = np.asarray(spec.cells, dtype=np.int64)
    b0, b1 = _boxes(geom, blk.bid)
    n0, n1 = _boxes(geom, nbid)
    # Work in sub-cell units (fine units x cells-per-block, per axis): every
    # block corner and cell corner lands on an integer coordinate for ANY
    # even cells-per-block, not just powers of two — the old formulation
    # divided the pow2 block side by the cell count, which is inexact unless
    # the cell count is itself a power of two.
    b0, b1 = b0 * ncells, b1 * ncells
    n0, n1 = n0 * ncells, n1 * ncells
    cb = (b1 - b0) // ncells  # own cell size per axis (exact: side * ncells / ncells)
    cn = (n1 - n0) // ncells  # neighbor cell size
    lo = np.maximum(b0 - g * cb, n0)
    hi = np.minimum(b1 + g * cb, n1)
    if np.any(hi <= lo):
        return None
    assert np.all((lo - b0) % cb == 0) and np.all((hi - lo) % cb == 0), (
        "cell alignment violated — cells per block must be even (octant "
        "split + halo alignment across a 2:1 level transition)"
    )
    t_lo = (lo - b0) // cb + g  # target array start (ghosted indices)
    w = (hi - lo) // cb  # target width in own cells
    target = tuple(slice(int(t_lo[d]), int(t_lo[d] + w[d])) for d in range(3))

    if nlevel == blk.level:
        s_lo = (lo - n0) // cn + g
        source = ("same", tuple(slice(int(s_lo[d]), int(s_lo[d] + w[d])) for d in range(3)))
    elif nlevel == blk.level + 1:  # neighbor finer: coalesce 2x2x2
        s_lo = (lo - n0) // cn + g
        source = (
            "fine",
            tuple(slice(int(s_lo[d]), int(s_lo[d] + 2 * w[d])) for d in range(3)),
        )
    else:  # neighbor coarser: explode (replicate covering coarse cell)
        idx = tuple(
            ((lo[d] + np.arange(int(w[d])) * cb[d] - n0[d]) // cn[d] + g).astype(np.int64)
            for d in range(3)
        )
        source = ("coarse", idx)
    return target, source


def _extract(arr: np.ndarray, kind: str, src) -> np.ndarray:
    """Extract + resample the source region (arr may have a leading Q axis)."""
    if kind == "same":
        return arr[..., src[0], src[1], src[2]]
    if kind == "fine":
        # 2x2x2 coalescence as a fixed-order sequential sum so the host path
        # and the compiled device path (compile_ghost_plan) round identically
        # in float32 — the fused conformance suite compares them at 1e-10.
        a = arr[..., src[0], src[1], src[2]]
        acc = None
        for dx, dy, dz in _OCTET_OFFSETS:
            part = a[..., dx::2, dy::2, dz::2]
            acc = part.copy() if acc is None else acc + part
        if np.issubdtype(arr.dtype, np.floating):
            return (acc * arr.dtype.type(0.125)).astype(arr.dtype)
        return (acc / 8).astype(arr.dtype)
    # coarse: fancy-index with per-axis replication maps
    ix, iy, iz = src
    return arr[..., ix[:, None, None], iy[None, :, None], iz[None, None, :]]


def _field_groups(
    spec: LBMBlockSpec | FieldRegistry, fields: tuple[str, ...]
) -> list[tuple[LBMBlockSpec, tuple[str, ...]]]:
    """Group exchanged fields by ghost width (one region geometry per group)."""
    if isinstance(spec, FieldRegistry):
        by_ghost: dict[int, list[str]] = {}
        for name in fields:
            by_ghost.setdefault(spec.fields[name].ghost, []).append(name)
        return [
            (LBMBlockSpec(cells=spec.cells, ghost=g), tuple(names))
            for g, names in by_ghost.items()
        ]
    return [(spec, tuple(fields))]


@_traced_plan("build_ghost_plan")
def build_ghost_plan(
    forest: BlockForest,
    spec: LBMBlockSpec | FieldRegistry,
    *,
    fields: tuple[str, ...] = ("pdf",),
    levels: set[int] | None = None,
) -> list[tuple]:
    """Precompute the ghost-exchange copy plan: one (target view, kind,
    source) entry per block/neighbor/field, with all geometry math and slice
    construction done once.

    Args:
        forest: the block forest whose ghost layers the plan refreshes.
        spec: an :class:`~repro.lbm.grid.LBMBlockSpec` (one ghost width for
            all ``fields``) or a :class:`~repro.core.fields.FieldRegistry`
            (each field uses the ghost width of its own declaration).
        fields: names of the per-block arrays to exchange.
        levels: restrict exchange *targets* to these refinement levels
            (``None`` = all). Sources are never restricted — a level-l
            block's ghosts may be sourced from level l-1/l/l+1 neighbors.

    Returns:
        A list of ``(target view, kind, source)`` entries consumed by
        :func:`run_ghost_plan`; ``kind`` is ``"same"`` (plain copy),
        ``"fine"`` (2x2x2 coalescence) or ``"coarse"`` (replicating
        explosion).

    The plan holds zero-copy views into the blocks' storage, so it stays
    valid exactly as long as the forest topology AND the backing arrays are
    unchanged — i.e. between arena adoptions; callers that cache plans must
    guard them with the validity token described in
    :func:`fill_ghost_layers`. This is the payoff of persistent
    :class:`~repro.core.fields.LevelArena` storage: the seed's per-substep
    restacking invalidated every array each step, making a persistent plan
    impossible.
    """
    groups = _field_groups(spec, fields)
    geom = forest.geom
    by_id: dict[int, Block] = {b.bid: b for b in forest.all_blocks()}
    plan: list[tuple] = []
    for blk in by_id.values():
        if levels is not None and blk.level not in levels:
            continue
        for nbid in blk.neighbors:
            nb = by_id[nbid]
            for sp, names in groups:
                reg = ghost_regions(geom, sp, blk, nbid, nb.level)
                if reg is None:
                    continue
                target, (kind, src) = reg
                for name in names:
                    tgt = blk.data[name][..., target[0], target[1], target[2]]
                    if kind == "same":  # fast path: a plain view-to-view copy
                        plan.append(
                            (tgt, kind, nb.data[name][..., src[0], src[1], src[2]])
                        )
                    else:
                        plan.append((tgt, kind, (nb.data[name], src)))
    return plan


def run_ghost_plan(plan: list[tuple]) -> None:
    """Execute a precomputed exchange plan (pure array copies/resampling)."""
    for tgt, kind, payload in plan:
        if kind == "same":
            tgt[...] = payload
        else:  # fine / coarse: resample through the shared extractor
            arr, src = payload
            tgt[...] = _extract(arr, kind, src)


def fill_ghost_layers(
    forest: BlockForest,
    spec: LBMBlockSpec | FieldRegistry,
    *,
    fields: tuple[str, ...] = ("pdf",),
    levels: set[int] | None = None,
    plan_cache: dict | None = None,
    cache_token=None,
) -> None:
    """Refresh ghost layers of all blocks (optionally only given levels).

    ``spec`` is either an :class:`LBMBlockSpec` (one ghost width for all
    ``fields``) or a :class:`FieldRegistry`, in which case each field uses
    the ghost width of its own declaration. Writes happen in place, so when
    blocks are arena-backed the level buffers are updated directly.

    With ``plan_cache`` (a dict owned by the caller) the exchange plan is
    built once per distinct level set and replayed on subsequent calls. Each
    cached plan carries a validity token and is rebuilt automatically when
    the token no longer matches, so a cache surviving a refine/coarsen/
    migration or arena rebind can never replay a stale plan. By default the
    token is the binding signature — leaf topology plus the identity of
    every participating storage array, an O(blocks) scan per call; callers
    that already version their storage (e.g. the driver via the arena
    version counter, which bumps on every adopt) can pass that counter as
    ``cache_token`` to make the guard O(1)."""
    run_ghost_plan(
        _cached_plan(
            plan_cache,
            levels,
            fields,
            _token_fn(forest, fields, cache_token),
            lambda: build_ghost_plan(forest, spec, fields=fields, levels=levels),
        )
    )


def _binding_token(forest: BlockForest, fields) -> list[tuple]:
    """Everything a cached exchange plan's validity depends on: the leaf
    topology (bid, level) plus the *identity* of each participating data
    array (plans hold zero-copy views into exactly these arrays). Ghost
    sources may live on any level, so the token always covers all blocks
    regardless of the plan's level filter."""
    return [
        (b.bid, b.level, tuple(b.data.get(name) for name in fields))
        for b in sorted(forest.all_blocks(), key=lambda b: b.bid)
    ]


def _token_fn(forest: BlockForest, fields, cache_token):
    """Validity-token thunk for the plan cache: a caller-supplied storage
    version when given (O(1) compare), the full binding signature otherwise."""
    if cache_token is not None:
        return lambda: ("version", cache_token)
    return lambda: _binding_token(forest, fields)


def _token_matches(cached, current) -> bool:
    if not (isinstance(cached, list) and isinstance(current, list)):
        return cached == current  # version tokens (or mixed kinds: mismatch)
    if len(cached) != len(current):
        return False
    for (bid_a, lvl_a, arrs_a), (bid_b, lvl_b, arrs_b) in zip(cached, current):
        if bid_a != bid_b or lvl_a != lvl_b or len(arrs_a) != len(arrs_b):
            return False
        # identity, not equality: a plan is bound to these exact arrays
        if any(x is not y for x, y in zip(arrs_a, arrs_b)):
            return False
    return True


def _cached_plan(plan_cache: dict | None, levels: set[int] | None, fields, token_fn, build):
    """Get-or-build an exchange plan keyed by (level set, fields), guarded by
    the binding token (stale entries are rebuilt, never replayed). The token
    is a thunk so uncached calls pay nothing for it."""
    if plan_cache is None:
        return build()
    token = token_fn()
    key = (None if levels is None else frozenset(levels), tuple(fields))
    entry = plan_cache.get(key)
    if entry is not None and _token_matches(entry[1], token):
        return entry[0]
    plan = build()
    plan_cache[key] = (plan, token)
    return plan


# -- compiled (device-executable) exchange plans --------------------------------


@dataclass(frozen=True)
class CompiledGhostOp:
    """One batched gather/scatter of a compiled exchange plan.

    Flat, concatenated index arrays for one (field, dst level, src level,
    resampling kind) combination: entry ``i`` fills cell ``dst_cell[i]`` of
    block-slot ``dst_slot[i]`` in the destination level's SoA buffer from
    source cell(s) ``src_cell[i]`` of slot(s) ``src_slot[i]`` in the source
    level's buffer. Cell ids are flat C-order indices into the ghosted
    spatial box of one block.

    * kind ``"same"`` / ``"coarse"``: src arrays are ``(N,)`` — a plain
      (possibly replicating) gather;
    * kind ``"fine"``: src arrays are ``(N, 8)`` — the 2x2x2 octet to
      coalesce, in the canonical offset order so a fixed-sequence sum
      reproduces the host extractor bit for bit.
    """

    field: str
    dst_level: int
    src_level: int
    kind: str  # "same" | "fine" | "coarse"
    dst_slot: np.ndarray
    dst_cell: np.ndarray
    src_slot: np.ndarray
    src_cell: np.ndarray

    @property
    def num_cells(self) -> int:
        return int(self.dst_cell.size)


@dataclass(frozen=True)
class CompiledGhostPlan:
    """A ghost exchange lowered to pure index arithmetic: no array views, no
    host copies — just gather/scatter maps over per-level SoA buffers,
    executable as ``jnp`` ops inside a jitted program (see
    ``repro.kernels.lbm_collide.ops.make_fused_superstep``). Valid as long
    as the forest topology and the arena slot assignment are unchanged."""

    fields: tuple[str, ...]
    levels: frozenset[int] | None
    ops: tuple[CompiledGhostOp, ...]

    @property
    def num_cells(self) -> int:
        return sum(op.num_cells for op in self.ops)


def _flat_cells(dims: tuple[int, int, int], ax: np.ndarray, ay: np.ndarray, az: np.ndarray) -> np.ndarray:
    """(len(ax), len(ay), len(az)) flat C-order cell ids from per-axis indices."""
    return (
        ax[:, None, None] * dims[1] + ay[None, :, None]
    ) * dims[2] + az[None, None, :]


def _srange(s: slice) -> np.ndarray:
    return np.arange(s.start, s.stop, dtype=np.int64)


def _lower_region_cells(
    sp: LBMBlockSpec, target, kind: str, src
) -> tuple[np.ndarray, np.ndarray]:
    """Lower one :func:`ghost_regions` result to flat C-order cell ids.

    Returns ``(tgt_cell, src_cell)``: ``tgt_cell`` is ``(N,)`` destination
    cell ids; ``src_cell`` is ``(N,)`` for ``"same"``/``"coarse"`` gathers or
    ``(N, 8)`` for ``"fine"`` coalescence, with the trailing octet axis in
    the canonical ``_OCTET_OFFSETS`` order so a fixed-sequence device sum is
    bitwise identical to the host extractor."""
    dims = tuple(c + 2 * sp.ghost for c in sp.cells)
    tgt_cell = _flat_cells(
        dims, _srange(target[0]), _srange(target[1]), _srange(target[2])
    ).ravel()
    if kind == "same":
        src_cell = _flat_cells(
            dims, _srange(src[0]), _srange(src[1]), _srange(src[2])
        ).ravel()
    elif kind == "fine":
        w = tuple(t.stop - t.start for t in target)
        off = np.arange(2, dtype=np.int64)
        fx = (src[0].start + 2 * np.arange(w[0], dtype=np.int64)[:, None] + off
              ).reshape(w[0], 1, 1, 2, 1, 1)
        fy = (src[1].start + 2 * np.arange(w[1], dtype=np.int64)[:, None] + off
              ).reshape(1, w[1], 1, 1, 2, 1)
        fz = (src[2].start + 2 * np.arange(w[2], dtype=np.int64)[:, None] + off
              ).reshape(1, 1, w[2], 1, 1, 2)
        # trailing (2,2,2) axes flatten to octet index dx*4+dy*2+dz
        # == the canonical _OCTET_OFFSETS order
        src_cell = ((fx * dims[1] + fy) * dims[2] + fz).reshape(-1, 8)
    else:  # coarse: per-axis replication maps (already ghosted ids)
        src_cell = _flat_cells(dims, src[0], src[1], src[2]).ravel()
    return tgt_cell, src_cell


@_traced_plan("compile_ghost_plan")
def compile_ghost_plan(
    forest: BlockForest,
    spec: LBMBlockSpec | FieldRegistry,
    slots: dict[int, dict[int, int]],
    *,
    fields: tuple[str, ...] = ("pdf",),
    levels: set[int] | None = None,
) -> CompiledGhostPlan:
    """Lower :func:`build_ghost_plan`'s region lists into flat gather/scatter
    index arrays addressed by (arena slot, flat ghosted-cell id).

    Args:
        forest: the block forest to compile the exchange for.
        spec: :class:`~repro.lbm.grid.LBMBlockSpec` or
            :class:`~repro.core.fields.FieldRegistry` (per-field ghost
            widths), as in :func:`build_ghost_plan`.
        slots: level -> bid -> slot (``LevelArena.slots``); must cover *all*
            blocks of the forest — targets are restricted to ``levels`` but
            ghost sources can live on any neighboring level.
        fields: names of the fields to exchange (one op group per field).
        levels: restrict exchange targets to these levels (``None`` = all).

    Returns:
        A :class:`CompiledGhostPlan` whose ops are batched per (field, dst
        level, src level, kind), so the whole exchange of a level set
        executes as a handful of vectorized ops regardless of block count.

    The compiled plan contains index arrays only (no array views); it stays
    valid as long as the forest topology and the slot assignment are
    unchanged, i.e. until the next arena ``adopt()`` — callers key their
    program caches on ``arena.version`` for exactly this reason.
    """
    groups = _field_groups(spec, fields)
    geom = forest.geom
    by_id: dict[int, Block] = {b.bid: b for b in forest.all_blocks()}
    acc: dict[tuple, list[tuple]] = {}
    for blk in by_id.values():
        if levels is not None and blk.level not in levels:
            continue
        t_slot = slots[blk.level][blk.bid]
        for nbid in blk.neighbors:
            nb = by_id[nbid]
            s_slot = slots[nb.level][nbid]
            for sp, names in groups:
                reg = ghost_regions(geom, sp, blk, nbid, nb.level)
                if reg is None:
                    continue
                target, (kind, src) = reg
                tgt_cell, src_cell = _lower_region_cells(sp, target, kind, src)
                n = tgt_cell.size
                dst_slot = np.full(n, t_slot, dtype=np.int32)
                src_slot = np.full(src_cell.shape, s_slot, dtype=np.int32)
                for name in names:
                    acc.setdefault((name, blk.level, nb.level, kind), []).append(
                        (dst_slot, tgt_cell, src_slot, src_cell)
                    )
    ops = tuple(
        CompiledGhostOp(
            field=name,
            dst_level=dl,
            src_level=sl,
            kind=kind,
            dst_slot=np.concatenate([e[0] for e in entries]),
            dst_cell=np.concatenate([e[1] for e in entries]).astype(np.int32),
            src_slot=np.concatenate([e[2] for e in entries]),
            src_cell=np.concatenate([e[3] for e in entries]).astype(np.int32),
        )
        for (name, dl, sl, kind), entries in sorted(acc.items())
    )
    return CompiledGhostPlan(
        fields=tuple(fields),
        levels=None if levels is None else frozenset(levels),
        ops=ops,
    )


@dataclass(frozen=True)
class HaloFillSegment:
    """One value-source segment of a merged per-level halo fill: gather
    ``src_cell`` (``(N,)`` or ``(N, 8)`` for fine coalescence, canonical
    octet order) from slots ``src_slot`` of ``src_level``'s buffer."""

    src_level: int
    kind: str  # "same" | "fine" | "coarse"
    src_slot: np.ndarray
    src_cell: np.ndarray


@dataclass(frozen=True)
class LevelHaloFill:
    """Halo-in-tile index map: *every* ghost fill targeting one destination
    level, merged into a single scatter.

    ``dst_slot``/``dst_cell`` are the concatenation of the plan's per-(src
    level, kind) op targets in op order; ``segments`` name the value sources
    in the same order, so ``concat(gather(seg) for seg in segments)`` lines
    up with the destination arrays row for row. Because every ghost cell is
    filled from exactly one source region, the merged scatter has no
    duplicate targets and is bitwise equal to the sequential per-op schedule
    — but it materializes the destination buffer once per level instead of
    once per op, and its index arrays can be handed straight to a halo-aware
    kernel (the stencil reads the ghost ring in-tile instead of waiting for
    a separately materialized exchanged buffer)."""

    field: str
    dst_level: int
    dst_slot: np.ndarray  # (N,)
    dst_cell: np.ndarray  # (N,)
    segments: tuple[HaloFillSegment, ...]

    @property
    def num_cells(self) -> int:
        return int(self.dst_cell.size)


def lower_halo_fill(plan: CompiledGhostPlan) -> dict[int, LevelHaloFill]:
    """Merge a single-field :class:`CompiledGhostPlan` into one
    :class:`LevelHaloFill` per destination level.

    All gather segments read *interior* cells of their source blocks (ghost
    regions are clipped to the neighbor's own box), and all scatter targets
    are ghost cells, so the upfront gather-everything-then-scatter-per-level
    schedule this enables is bitwise identical to interleaving the plan's
    ops one by one."""
    assert len({op.field for op in plan.ops}) <= 1, (
        "lower_halo_fill merges one field's ops; compile one plan per field"
    )
    by_level: dict[int, list[CompiledGhostOp]] = {}
    for op in plan.ops:  # plan op order is the deterministic sorted-acc order
        by_level.setdefault(op.dst_level, []).append(op)
    return {
        dl: LevelHaloFill(
            field=ops[0].field,
            dst_level=dl,
            dst_slot=np.concatenate([op.dst_slot for op in ops]),
            dst_cell=np.concatenate([op.dst_cell for op in ops]),
            segments=tuple(
                HaloFillSegment(
                    src_level=op.src_level,
                    kind=op.kind,
                    src_slot=op.src_slot,
                    src_cell=op.src_cell,
                )
                for op in ops
            ),
        )
        for dl, ops in sorted(by_level.items())
    }


# -- rank-sharded exchange (cross-rank ghosts as p2p messages) ------------------


@dataclass
class RankHaloPlan:
    """Precomputed sharded exchange: in-place intra-rank copies plus one
    batched point-to-point message per communicating rank pair.

    ``sends[(src, dst)]`` and ``recvs[(src, dst)]`` are index-aligned: entry
    ``i`` of the send list produces the patch that entry ``i`` of the receive
    list writes into. Senders only read arrays owned by ``src``; receivers
    only write arrays owned by ``dst`` — rank-locality by construction.
    """

    local: list[tuple] = field(default_factory=list)  # run_ghost_plan entries
    sends: dict[tuple[int, int], list[tuple]] = field(default_factory=dict)
    recvs: dict[tuple[int, int], list[np.ndarray]] = field(default_factory=dict)
    nbytes: dict[tuple[int, int], int] = field(default_factory=dict)

    def rank_pairs(self) -> set[tuple[int, int]]:
        return set(self.sends)

    def cross_rank_bytes(self) -> int:
        return sum(self.nbytes.values())


@_traced_plan("build_rank_halo_plan")
def build_rank_halo_plan(
    forest: BlockForest,
    spec: LBMBlockSpec | FieldRegistry,
    *,
    fields: tuple[str, ...] = ("pdf",),
    levels: set[int] | None = None,
) -> RankHaloPlan:
    """Split the ghost-exchange plan by ownership: same-owner pairs become
    in-place copies, cross-owner pairs become (sender extract, receiver
    write) entries batched per rank pair.

    Args:
        forest: the block forest (``Block.owner`` decides intra vs cross).
        spec: :class:`~repro.lbm.grid.LBMBlockSpec` or
            :class:`~repro.core.fields.FieldRegistry`, as in
            :func:`build_ghost_plan`.
        fields: names of the per-block arrays to exchange.
        levels: restrict exchange targets to these levels (``None`` = all).

    Returns:
        A :class:`RankHaloPlan`; execute it with :func:`run_rank_halo_plan`.

    Like :func:`build_ghost_plan` the plan holds zero-copy views, so it
    stays valid between arena adoptions only; cached plans are guarded by
    the same validity token (see :func:`fill_ghost_layers`) and rebuilt
    automatically when the forest topology or storage binding changed."""
    groups = _field_groups(spec, fields)
    geom = forest.geom
    by_id: dict[int, Block] = {b.bid: b for b in forest.all_blocks()}
    plan = RankHaloPlan()
    for blk in by_id.values():
        if levels is not None and blk.level not in levels:
            continue
        for nbid in blk.neighbors:
            nb = by_id[nbid]
            for sp, names in groups:
                reg = ghost_regions(geom, sp, blk, nbid, nb.level)
                if reg is None:
                    continue
                target, (kind, src) = reg
                for name in names:
                    tgt = blk.data[name][..., target[0], target[1], target[2]]
                    if nb.owner == blk.owner:
                        if kind == "same":
                            plan.local.append(
                                (tgt, kind, nb.data[name][..., src[0], src[1], src[2]])
                            )
                        else:
                            plan.local.append((tgt, kind, (nb.data[name], src)))
                    else:
                        # data flows owner(neighbor) -> owner(block); §2 next-
                        # neighbor property: communicating ranks must be
                        # process-graph neighbors (pinned by the conformance
                        # suite via rank_pairs()).
                        pair = (nb.owner, blk.owner)
                        plan.sends.setdefault(pair, []).append(
                            (nb.data[name], kind, src)
                        )
                        plan.recvs.setdefault(pair, []).append(tgt)
                        plan.nbytes[pair] = plan.nbytes.get(pair, 0) + tgt.nbytes
    return plan


def run_rank_halo_plan(plan: RankHaloPlan, comm: Comm) -> None:
    """Execute a sharded exchange: local copies in place, then one p2p
    message per rank pair (sender-side resampling) and one delivery round."""
    run_ghost_plan(plan.local)
    if not plan.sends:
        return  # nothing crosses a rank boundary: no communication round
    for (src_rank, dst_rank), entries in plan.sends.items():
        patches = [
            np.ascontiguousarray(_extract(arr, kind, src))
            for arr, kind, src in entries
        ]
        comm.send(
            src_rank,
            dst_rank,
            "halo",
            ((src_rank, dst_rank), patches),
            nbytes=plan.nbytes[(src_rank, dst_rank)],
        )
    inbox = comm.exchange()
    for _dst, msgs in inbox.items():
        for _tag, (pair, patches) in msgs:
            targets = plan.recvs[pair]
            assert len(patches) == len(targets), pair
            for tgt, patch in zip(targets, patches):
                tgt[...] = patch


def fill_ghost_layers_sharded(
    forest: BlockForest,
    spec: LBMBlockSpec | FieldRegistry,
    comm: Comm,
    *,
    fields: tuple[str, ...] = ("pdf",),
    levels: set[int] | None = None,
    plan_cache: dict | None = None,
    cache_token=None,
) -> RankHaloPlan:
    """Sharded counterpart of :func:`fill_ghost_layers`: refresh ghost layers
    with intra-rank in-place copies and cross-rank p2p messages through
    ``comm``. Returns the plan used (for traffic introspection). The caller
    owns ``plan_cache``; stale entries are detected (and rebuilt) through the
    same validity token as :func:`fill_ghost_layers`."""
    plan = _cached_plan(
        plan_cache,
        levels,
        fields,
        _token_fn(forest, fields, cache_token),
        lambda: build_rank_halo_plan(forest, spec, fields=fields, levels=levels),
    )
    run_rank_halo_plan(plan, comm)
    return plan


# -- compiled rank-sharded exchange (device-built p2p messages) ------------------


@dataclass(frozen=True)
class CompiledRankMessage:
    """One rank pair's batched halo message, lowered to device index arrays.

    The message payload for the pair is a single ``(num_cells, C)`` array per
    field (``C`` = product of the field's leading component axes, e.g. Q for
    PDFs), built *on the sender's device* by concatenating the ``gather``
    segments in order — resampling (fine->coarse coalescence, coarse->fine
    replication) happens sender-side exactly as in :class:`RankHaloPlan`,
    with the canonical fixed-order octet sum so device == host bitwise. The
    receiver writes the payload into its own buffers by walking the
    ``scatter`` segments over the same consecutive cell ranges, so sender and
    receiver lowering agree by construction (both sides are emitted by the
    same loop in :func:`compile_rank_halo_plan`).

    ``gather`` entries are ``(src_level, kind, src_slot, src_cell)`` — slots
    index the *sender's* rank-local per-level buffers; ``src_cell`` is
    ``(N,)`` or ``(N, 8)`` as in :class:`CompiledGhostOp`. ``scatter``
    entries are ``(dst_level, dst_slot, dst_cell, ncells)`` — slots index the
    *receiver's* rank-local buffers. ``nbytes`` is the payload size the
    ``Comm`` fabric accounts for the pair (identical to the host-plan patch
    bytes, so Table-1 numbers are mode-independent).
    """

    src_rank: int
    dst_rank: int
    field: str
    nbytes: int
    num_cells: int
    gather: tuple[tuple[int, str, np.ndarray, np.ndarray], ...]
    scatter: tuple[tuple[int, np.ndarray, np.ndarray, int], ...]

    @property
    def key(self) -> tuple[int, int, str]:
        """Routing key carried alongside the payload on the fabric."""
        return (self.src_rank, self.dst_rank, self.field)


@dataclass(frozen=True)
class CompiledRankHaloPlan:
    """A sharded ghost exchange lowered to pure index arithmetic per rank.

    The device analogue of :class:`RankHaloPlan`: ``local[r]`` is rank r's
    intra-rank exchange as a :class:`CompiledGhostPlan` over its *rank-local*
    arena slots (executable inside r's jitted program), and ``messages``
    holds one :class:`CompiledRankMessage` per (communicating rank pair,
    field) — so the ``Comm`` fabric still sees exactly one p2p message per
    neighboring rank pair per exchange, only now the payload is a
    device-built buffer instead of a list of host patches. Valid as long as
    the forest topology and every rank's slot assignment are unchanged
    (callers key caches on ``RankArenas.version``).
    """

    fields: tuple[str, ...]
    levels: frozenset[int] | None
    local: dict[int, CompiledGhostPlan]
    messages: tuple[CompiledRankMessage, ...]

    def rank_pairs(self) -> set[tuple[int, int]]:
        return {(m.src_rank, m.dst_rank) for m in self.messages}

    def cross_rank_bytes(self) -> int:
        return sum(m.nbytes for m in self.messages)


@_traced_plan("compile_rank_halo_plan")
def compile_rank_halo_plan(
    forest: BlockForest,
    spec: LBMBlockSpec | FieldRegistry,
    rank_slots: dict[int, dict[int, dict[int, int]]],
    *,
    fields: tuple[str, ...] = ("pdf",),
    levels: set[int] | None = None,
) -> CompiledRankHaloPlan:
    """Lower :func:`build_rank_halo_plan`'s ownership-split exchange into
    flat gather/scatter index arrays addressed by *rank-local* arena slots.

    Args:
        forest: the block forest (``Block.owner`` decides intra vs cross).
        spec: :class:`~repro.lbm.grid.LBMBlockSpec` or
            :class:`~repro.core.fields.FieldRegistry`, as in
            :func:`build_ghost_plan`.
        rank_slots: rank -> level -> bid -> slot, i.e.
            ``{r: {l: arenas.per_rank[r].slots(l)}}`` for a
            :class:`~repro.core.fields.RankArenas` — every block must appear
            in its owner's slot map (sources are never level-restricted).
        fields: names of the fields to exchange.
        levels: restrict exchange targets to these levels (``None`` = all).

    Returns:
        A :class:`CompiledRankHaloPlan`. Intra-rank copies become per-rank
        :class:`CompiledGhostOp` batches; cross-rank patches become
        per-rank-pair :class:`CompiledRankMessage` specs whose payloads are
        gathered on the sender's device and scattered on the receiver's.

    This is the same treatment :func:`compile_ghost_plan` gave the
    single-arena region lists, applied to the sharded plan: the host-side
    numpy patch resampling of :func:`run_rank_halo_plan` disappears, and the
    only per-substep host involvement left is routing the (device-resident)
    message buffers through the ``Comm`` fabric.
    """
    groups = _field_groups(spec, fields)
    geom = forest.geom
    by_id: dict[int, Block] = {b.bid: b for b in forest.all_blocks()}
    local_acc: dict[int, dict[tuple, list[tuple]]] = {}
    # (src_rank, dst_rank, field) -> (src_level, kind) -> aligned seg lists
    msg_acc: dict[tuple, dict[tuple, list[tuple]]] = {}
    lead: dict[str, int] = {}
    itemsize: dict[str, int] = {}
    if isinstance(spec, FieldRegistry):
        for name in fields:
            fs = spec.fields[name]
            lead[name] = int(np.prod(fs.shape, dtype=np.int64)) if fs.shape else 1
            itemsize[name] = np.dtype(fs.dtype).itemsize
    else:
        for name in fields:
            lead[name] = spec.lattice.Q if name == "pdf" else 1
            itemsize[name] = np.dtype(spec.dtype).itemsize
    for blk in by_id.values():
        if levels is not None and blk.level not in levels:
            continue
        t_slot = rank_slots[blk.owner][blk.level][blk.bid]
        for nbid in blk.neighbors:
            nb = by_id[nbid]
            s_slot = rank_slots[nb.owner][nb.level][nbid]
            for sp, names in groups:
                reg = ghost_regions(geom, sp, blk, nbid, nb.level)
                if reg is None:
                    continue
                target, (kind, src) = reg
                tgt_cell, src_cell = _lower_region_cells(sp, target, kind, src)
                n = tgt_cell.size
                dst_slot = np.full(n, t_slot, dtype=np.int32)
                src_slot = np.full(src_cell.shape, s_slot, dtype=np.int32)
                for name in names:
                    if nb.owner == blk.owner:
                        local_acc.setdefault(blk.owner, {}).setdefault(
                            (name, blk.level, nb.level, kind), []
                        ).append((dst_slot, tgt_cell, src_slot, src_cell))
                    else:
                        # data flows owner(neighbor) -> owner(block); one
                        # aligned append per side keeps sender gather order
                        # == receiver scatter order by construction
                        msg_acc.setdefault(
                            (nb.owner, blk.owner, name), {}
                        ).setdefault((nb.level, kind), []).append(
                            (src_slot, src_cell, blk.level, dst_slot, tgt_cell)
                        )
    local = {
        rank: CompiledGhostPlan(
            fields=tuple(fields),
            levels=None if levels is None else frozenset(levels),
            ops=tuple(
                CompiledGhostOp(
                    field=name,
                    dst_level=dl,
                    src_level=sl,
                    kind=kind,
                    dst_slot=np.concatenate([e[0] for e in entries]),
                    dst_cell=np.concatenate([e[1] for e in entries]).astype(np.int32),
                    src_slot=np.concatenate([e[2] for e in entries]),
                    src_cell=np.concatenate([e[3] for e in entries]).astype(np.int32),
                )
                for (name, dl, sl, kind), entries in sorted(acc.items())
            ),
        )
        for rank, acc in local_acc.items()
    }
    messages = []
    for (src_rank, dst_rank, name), seg_map in sorted(msg_acc.items()):
        gather, scatter, total = [], [], 0
        for (src_level, kind), entries in sorted(seg_map.items()):
            g_slot = np.concatenate([e[0] for e in entries])
            g_cell = np.concatenate([e[1] for e in entries]).astype(np.int32)
            gather.append((src_level, kind, g_slot, g_cell))
            # within a (src_level, kind) segment all dst levels agree (the
            # kind fixes the level offset), so one scatter segment suffices
            dst_levels = {e[2] for e in entries}
            assert len(dst_levels) == 1, (src_rank, dst_rank, name, dst_levels)
            d_slot = np.concatenate([e[3] for e in entries])
            d_cell = np.concatenate([e[4] for e in entries]).astype(np.int32)
            scatter.append((dst_levels.pop(), d_slot, d_cell, int(d_cell.size)))
            total += int(d_cell.size)
        messages.append(
            CompiledRankMessage(
                src_rank=src_rank,
                dst_rank=dst_rank,
                field=name,
                nbytes=total * lead[name] * itemsize[name],
                num_cells=total,
                gather=tuple(gather),
                scatter=tuple(scatter),
            )
        )
    return CompiledRankHaloPlan(
        fields=tuple(fields),
        levels=None if levels is None else frozenset(levels),
        local=local,
        messages=tuple(messages),
    )


# ---------------------------------------------------------------------------
# Device-fabric lowering: ppermute rounds + equal-blocks-per-rank padding
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PpermuteRound:
    """One ``jax.lax.ppermute`` call covering a set of rank-pair messages.

    ``ppermute`` is a partial permutation: each device sends at most one
    payload and receives at most one per call. A halo exchange generally has
    several messages per rank (one per neighboring pair and field), so the
    message set is decomposed into rounds where every source and every
    destination appears at most once. ``perm`` is the ``(src, dst)`` list in
    the exact form ``ppermute`` takes; ``messages`` is aligned with it, and
    ``num_cells`` is the padded per-payload row count for the round (every
    participant ships the same shape — the SPMD program is identical on all
    ranks, shorter messages are zero-padded and the pad rows are dropped by
    the receiver's scatter, which only reads ``message.num_cells`` rows).
    """

    perm: tuple[tuple[int, int], ...]
    messages: tuple[CompiledRankMessage, ...]
    num_cells: int

    def pad_cells(self) -> int:
        """Zero rows shipped beyond the logical payloads (wire overhead)."""
        return sum(self.num_cells - m.num_cells for m in self.messages)


def schedule_ppermute_rounds(
    messages: tuple[CompiledRankMessage, ...],
) -> tuple[PpermuteRound, ...]:
    """Greedily decompose rank-pair messages into partial permutations.

    Messages are scanned in the deterministic plan order (sorted by
    ``(src_rank, dst_rank, field)`` — :func:`compile_rank_halo_plan` emits
    them that way) and each is placed in the first round where its source is
    not yet sending and its destination not yet receiving, so the schedule is
    a pure function of the plan. For the face-neighbor traffic of an SFC
    partition this yields O(max rank degree) rounds, independent of the rank
    count — the per-process boundedness column of Table 1 carried over to the
    collective schedule.
    """
    rounds: list[tuple[list[tuple[int, int]], list[CompiledRankMessage]]] = []
    for m in messages:
        for perm, ms in rounds:
            if all(s != m.src_rank for s, _ in perm) and all(
                d != m.dst_rank for _, d in perm
            ):
                perm.append((m.src_rank, m.dst_rank))
                ms.append(m)
                break
        else:
            rounds.append(([(m.src_rank, m.dst_rank)], [m]))
    return tuple(
        PpermuteRound(
            perm=tuple(perm),
            messages=tuple(ms),
            num_cells=max(m.num_cells for m in ms),
        )
        for perm, ms in rounds
    )


def padded_block_counts(
    rank_slots: dict[int, dict[int, dict[int, int]]], nranks: int
) -> dict[int, int]:
    """Per-level block-stack height shared by every rank (max over ranks).

    The device fabric runs one SPMD program, so each level's block stack must
    have the same shape on every rank: ranks owning fewer blocks pad with
    masked slots (all-WALL mask, weight-vector PDFs — an exact fixed point of
    the kernel, see ``DeviceShardedEngine``). Rank-local slot ids stay valid
    in the padded ``(nranks, count, ...)`` layout unchanged, because arenas
    assign slots densely from zero.
    """
    counts: dict[int, int] = {}
    for r in range(nranks):
        for lvl, slots in rank_slots.get(r, {}).items():
            counts[lvl] = max(counts.get(lvl, 0), len(slots))
    return counts


def verify_padded_plan(
    plan: CompiledRankHaloPlan,
    rank_slots: dict[int, dict[int, dict[int, int]]],
) -> list[str]:
    """Prove the lowered plan never reads or writes a padded slot.

    Every gather/scatter slot index must address a *real* block of the
    owning rank (slot < that rank's block count on the level); the padded
    slots above are only ever touched by the kernel's masked no-op step.
    Returns human-readable violations (empty == safe), in the style of
    ``repro.analysis.plan_verify``.
    """
    problems: list[str] = []

    def nblocks(rank: int, level: int) -> int:
        return len(rank_slots.get(rank, {}).get(level, {}))

    for rank, local in plan.local.items():
        for op in local.ops:
            if op.dst_slot.size and int(op.dst_slot.max()) >= nblocks(rank, op.dst_level):
                problems.append(
                    f"local[{rank}] {op.field}: dst_slot {int(op.dst_slot.max())} "
                    f"exceeds {nblocks(rank, op.dst_level)} blocks at level {op.dst_level}"
                )
            if op.src_slot.size and int(op.src_slot.max()) >= nblocks(rank, op.src_level):
                problems.append(
                    f"local[{rank}] {op.field}: src_slot {int(op.src_slot.max())} "
                    f"exceeds {nblocks(rank, op.src_level)} blocks at level {op.src_level}"
                )
    for m in plan.messages:
        for src_level, _kind, src_slot, _src_cell in m.gather:
            if src_slot.size and int(src_slot.max()) >= nblocks(m.src_rank, src_level):
                problems.append(
                    f"message {m.key}: gather slot {int(src_slot.max())} exceeds "
                    f"{nblocks(m.src_rank, src_level)} blocks at level {src_level}"
                )
        for dst_level, dst_slot, _dst_cell, _n in m.scatter:
            if dst_slot.size and int(dst_slot.max()) >= nblocks(m.dst_rank, dst_level):
                problems.append(
                    f"message {m.key}: scatter slot {int(dst_slot.max())} exceeds "
                    f"{nblocks(m.dst_rank, dst_level)} blocks at level {dst_level}"
                )
    return problems
