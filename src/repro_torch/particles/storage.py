"""Meshless per-block particle storage on the block forest (paper §2.5).

The paper's blocks "support the storage of arbitrary data", so the framework
serves "mesh based and meshless methods" — this module exercises that claim
with Lagrangian passive tracers. Every block stores one variable-length
struct-of-arrays particle set::

    Block.data["particles"] = {
        "pos": (N, 3) float64   world-coordinate positions,
        "vel": (N, 3) float64   world-coordinate velocities (diagnostic),
        "id":  (N,)   int64     globally unique, immutable particle ids,
    }

ordered ascending by id (every mutation re-establishes the ordering, so the
arrays are bit-identical for any rank count or stepping mode).

:func:`register_particles` plugs the set into the §2.5 serialization
machinery as one :class:`~repro.core.migration.BlockDataItem`, so **data
migration, checkpoint/restart, and buddy resilience come for free**:

* **move** — the whole set travels unmodified;
* **split** — each particle is routed to the child octant that owns its
  position (mid-plane comparisons partition the set exactly: every particle
  lands in exactly one octant, so refinement conserves the particle count
  even for positions marginally outside the parent's box);
* **merge** — the eight children's sets are concatenated on the target (the
  sender ships its set unmodified; there is no volumetric restriction for
  meshless data) and re-sorted by id.

Unlike mesh fields, particle sets are *ragged*: payload byte accounting goes
through :func:`repro.core.migration.payload_nbytes`, which sizes
dict-of-ndarray payloads exactly — the Table-1 migration-volume numbers stay
truthful with particles in flight. Particle sets are deliberately **not**
arena-backed (``FieldRegistry.fields`` drives the arenas; opaque items
registered through the base ``register()`` stay per-block host data).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable

import numpy as np

from ..core.blockid import ForestGeometry, parent_id
from ..core.forest import Block, BlockForest
from ..core.migration import BlockDataItem, BlockDataRegistry

__all__ = [
    "PARTICLE_FIELDS",
    "ParticlesConfig",
    "empty_particles",
    "num_particles",
    "take",
    "concat_particles",
    "sort_by_id",
    "particles_nbytes",
    "block_box",
    "octant_index",
    "find_leaf",
    "register_particles",
    "seed_particles",
    "total_particles",
    "all_particles",
]

# canonical SoA layout: name -> (dtype, trailing shape)
PARTICLE_FIELDS: tuple[tuple[str, Any, tuple[int, ...]], ...] = (
    ("pos", np.float64, (3,)),
    ("vel", np.float64, (3,)),
    ("id", np.int64, ()),
)


@dataclass(frozen=True)
class ParticlesConfig:
    """Driver-facing configuration of the Lagrangian tracer layer.

    ``alpha`` feeds the load model ``weight(block) = cells + alpha * N`` (see
    :mod:`repro.particles.balance`); ``boundary`` selects the domain behavior
    of escaping particles (``"reflect"`` matches the cavity's solid walls,
    ``"periodic"`` wraps); ``region`` optionally restricts seeding to a world
    AABB ``(lo, hi)`` so tracers can be clustered (heterogeneous load)."""

    per_block: int = 8
    seed: int = 0
    alpha: float = 0.05
    boundary: str = "reflect"  # | "periodic"
    region: tuple[tuple[float, float, float], tuple[float, float, float]] | None = None


def empty_particles() -> dict[str, np.ndarray]:
    return {
        name: np.empty((0, *shape), dtype=dtype)
        for name, dtype, shape in PARTICLE_FIELDS
    }


def num_particles(p: dict[str, np.ndarray] | None) -> int:
    return 0 if p is None else int(p["id"].shape[0])


def take(p: dict[str, np.ndarray], sel) -> dict[str, np.ndarray]:
    """Subset by boolean mask or index array (copies, order-preserving)."""
    return {k: v[sel] for k, v in p.items()}


def concat_particles(parts: Iterable[dict[str, np.ndarray] | None]) -> dict[str, np.ndarray]:
    parts = [p for p in parts if p is not None]
    if not parts:
        return empty_particles()
    return {
        name: np.concatenate([np.asarray(p[name], dtype=dtype) for p in parts])
        for name, dtype, _shape in PARTICLE_FIELDS
    }


def sort_by_id(p: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Canonical ordering: ascending id. Every mutation path re-sorts, so a
    block's arrays are identical regardless of message arrival order — the
    cross-rank/cross-mode conformance suite compares them at 1e-10."""
    order = np.argsort(p["id"], kind="stable")
    return take(p, order)


def _validated(p: Any) -> dict[str, np.ndarray]:
    """Canonicalize an external payload (checkpoint/resilience restore) to
    the declared dtypes/shapes; raises on structural mismatch."""
    if p is None:
        return empty_particles()
    out: dict[str, np.ndarray] = {}
    n = None
    for name, dtype, shape in PARTICLE_FIELDS:
        if name not in p:  # external input — must survive python -O
            raise ValueError(f"particle payload missing {name!r}")
        arr = np.asarray(p[name], dtype=dtype)
        if arr.shape[1:] != shape:
            raise ValueError(f"particle {name!r}: shape {arr.shape} != (N, {shape})")
        if n is None:
            n = arr.shape[0]
        elif arr.shape[0] != n:
            raise ValueError(f"particle {name!r}: ragged length {arr.shape[0]} != {n}")
        out[name] = arr
    return out


def particles_nbytes(p: dict[str, np.ndarray] | None) -> int:
    return 0 if p is None else sum(v.nbytes for v in p.values())


# -- geometry helpers -------------------------------------------------------------


def block_box(geom: ForestGeometry, bid: int) -> tuple[np.ndarray, np.ndarray]:
    """Block AABB in world units (one root block = unit cube), half-open."""
    box = np.asarray(geom.aabb(bid), dtype=np.float64)
    scale = 1.0 / (1 << geom.max_level)
    return box[:3] * scale, box[3:] * scale


def octant_index(geom: ForestGeometry, bid: int, pos: np.ndarray) -> np.ndarray:
    """Child octant owning each position: mid-plane comparisons (>= -> upper
    half), so the eight masks partition ANY position set exactly."""
    lo, hi = block_box(geom, bid)
    mid = 0.5 * (lo + hi)
    up = pos >= mid  # (N, 3) bool
    return (
        up[:, 0].astype(np.int64)
        | (up[:, 1].astype(np.int64) << 1)
        | (up[:, 2].astype(np.int64) << 2)
    )


def find_leaf(geom: ForestGeometry, leaves: dict[int, Any], pos) -> int | None:
    """The leaf block containing a world position, or None outside the
    domain. O(max_level) id arithmetic — used by the periodic-wrap routing
    fallback and by tests as the containment oracle."""
    full = 1 << geom.max_level
    fx, fy, fz = (int(np.floor(float(c) * full)) for c in pos)
    rx, ry, rz = fx // full, fy // full, fz // full
    gx, gy, gz = geom.root_grid
    if not (0 <= rx < gx and 0 <= ry < gy and 0 <= rz < gz):
        return None
    bid = geom.id_from_coords(
        geom.max_level, fx - rx * full, fy - ry * full, fz - rz * full,
        geom.root_index(rx, ry, rz),
    )
    while bid.bit_length() > geom.root_bits:
        if bid in leaves:
            return bid
        bid = parent_id(bid)
    return None


# -- §2.5 registration -------------------------------------------------------------


def register_particles(
    registry: BlockDataRegistry,
    geom: ForestGeometry,
    name: str = "particles",
) -> str:
    """Register the particle set as one block-data item: the six migration
    callbacks (and through them checkpoint encode/decode and resilience
    snapshot/restore) are derived here. Works on any registry — typed
    :class:`~repro.core.fields.FieldRegistry` included, where the set stays
    out of the arenas (it has no per-cell mesh layout to pack)."""

    def ser_move(d: Any, _blk: Block) -> dict[str, np.ndarray]:
        return d if d is not None else empty_particles()

    def des_move(p: Any, _blk: Block) -> dict[str, np.ndarray]:
        return _validated(p)

    def ser_split(d: Any, blk: Block, o: int) -> dict[str, np.ndarray]:
        if num_particles(d) == 0:
            return empty_particles()
        return take(d, octant_index(geom, blk.bid, d["pos"]) == o)

    def des_split(p: Any, _blk: Block) -> dict[str, np.ndarray]:
        return _validated(p)

    def ser_merge(d: Any, _blk: Block) -> dict[str, np.ndarray]:
        # meshless merge: the fine set travels unmodified (no restriction)
        return d if d is not None else empty_particles()

    def des_merge(parts: dict[int, Any], _blk: Block) -> dict[str, np.ndarray]:
        return sort_by_id(concat_particles(parts[o] for o in sorted(parts)))

    registry.register(
        name,
        BlockDataItem(
            serialize_move=ser_move,
            deserialize_move=des_move,
            serialize_split=ser_split,
            deserialize_split=des_split,
            serialize_merge=ser_merge,
            deserialize_merge=des_merge,
        ),
    )
    return name


# -- seeding & whole-forest queries -------------------------------------------------


def seed_particles(
    forest: BlockForest,
    geom: ForestGeometry,
    *,
    per_block: int,
    seed: int = 0,
    region: tuple | None = None,
    name: str = "particles",
) -> int:
    """Seed ``per_block`` tracers uniformly into every block (optionally only
    where the block intersects the world AABB ``region``, drawn inside the
    intersection — the clustering hook for heterogeneous-load scenarios).

    Ids are assigned along ascending bid and the per-block RNG streams are
    keyed by ``(seed, bid)``, so seeding is identical for any rank count.
    Returns the total number of particles seeded."""
    total = 0
    for blk in sorted(forest.all_blocks(), key=lambda b: b.bid):
        lo, hi = block_box(geom, blk.bid)
        if region is not None:
            lo = np.maximum(lo, np.asarray(region[0], dtype=np.float64))
            hi = np.minimum(hi, np.asarray(region[1], dtype=np.float64))
        n = per_block if np.all(hi > lo) else 0
        if n:
            rng = np.random.default_rng([seed, blk.bid])
            pos = lo + rng.random((n, 3)) * (hi - lo)
            ids = np.arange(total, total + n, dtype=np.int64)
            blk.data[name] = {
                "pos": pos,
                "vel": np.zeros((n, 3), dtype=np.float64),
                "id": ids,
            }
        else:
            blk.data[name] = empty_particles()
        total += n
    return total


def total_particles(forest: BlockForest, name: str = "particles") -> int:
    return sum(num_particles(b.data.get(name)) for b in forest.all_blocks())


def all_particles(forest: BlockForest, name: str = "particles") -> dict[str, np.ndarray]:
    """Whole-forest particle state sorted by id (verification/diagnostics)."""
    return sort_by_id(
        concat_particles(b.data.get(name) for b in forest.all_blocks())
    )
