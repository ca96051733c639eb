"""Cross-block / cross-rank particle redistribution over the Comm fabric.

After advection some particles sit outside their block's AABB. Redistribution
(run once per coarse step) applies the domain boundary condition, then routes
every escaped particle to the leaf block containing its new position:

* **intra-rank** moves are direct host-side deliveries;
* **cross-rank** moves travel as point-to-point messages over the same
  :class:`~repro.core.comm.Comm` fabric the sharded halo exchange uses — all
  particles from rank *i* to rank *j* are batched into **one message per
  neighboring rank pair** per step, with exact byte accounting
  (:func:`~repro.core.migration.payload_nbytes` sizes the ragged SoA payloads
  honestly), delivered in a single exchange round.

Because one coarse step moves a tracer by at most ``max|u| / n`` world units
(far less than a block side), the containing leaf is always *adjacent* to the
source block, so routing needs only the block's own neighbor list — the
paper's next-neighbor communication property holds for particle traffic too.
The one exception is a periodic wrap across the domain, where the target sits
on the far side: those few particles are routed through a global leaf lookup
(``find_leaf``); a production mesh with periodic topology would instead carry
periodic adjacency and stay next-neighbor.

Domain boundaries:

* ``"reflect"`` — mirror the position at the wall and flip the velocity
  component (matches the cavity's solid walls and lid);
* ``"periodic"`` — wrap positions modulo the domain extent.

Both then clamp positions into the half-open domain box so every particle is
contained in exactly one leaf.
"""

from __future__ import annotations

import numpy as np

from ..core.blockid import ForestGeometry
from ..core.comm import BYTES_BLOCK_ID, Comm
from ..core.forest import BlockForest
from ..core.migration import payload_nbytes

from .storage import (
    block_box,
    concat_particles,
    empty_particles,
    find_leaf,
    num_particles,
    sort_by_id,
    take,
)

__all__ = ["apply_domain_boundary", "redistribute_particles"]


def apply_domain_boundary(
    pos: np.ndarray,
    vel: np.ndarray,
    hi_dom: np.ndarray,
    boundary: str,
) -> tuple[np.ndarray, np.ndarray]:
    """Map positions back into the half-open domain box [0, hi_dom).

    One reflection per side suffices: a coarse step moves a tracer far less
    than the domain extent. Returned arrays are fresh copies."""
    pos = np.array(pos)
    vel = np.array(vel)
    if boundary == "periodic":
        pos = np.mod(pos, hi_dom)
    elif boundary == "reflect":
        for d in range(3):
            below = pos[:, d] < 0.0
            pos[below, d] = -pos[below, d]
            vel[below, d] = -vel[below, d]
            above = pos[:, d] > hi_dom[d]
            pos[above, d] = 2.0 * hi_dom[d] - pos[above, d]
            vel[above, d] = -vel[above, d]
    else:
        raise ValueError(f"unknown boundary {boundary!r}")
    # half-open containment: a position exactly on the upper face belongs to
    # no leaf — nudge it to the last representable interior coordinate
    np.minimum(pos, np.nextafter(hi_dom, 0.0), out=pos)
    np.maximum(pos, 0.0, out=pos)
    return pos, vel


def redistribute_particles(
    forest: BlockForest,
    geom: ForestGeometry,
    comm: Comm,
    *,
    boundary: str = "reflect",
    name: str = "particles",
) -> tuple[int, int]:
    """Route escaped particles to their containing leaf block/rank.

    Returns ``(moved, cross_rank_bytes)``: the number of particles that
    changed blocks and the p2p payload bytes that crossed rank boundaries
    (zero when every move was intra-rank — then no exchange round is spent,
    mirroring the sharded halo's no-traffic fast path)."""
    R = forest.nranks
    hi_dom = np.asarray(geom.root_grid, dtype=np.float64)
    deliveries: list[list[tuple[int, dict[str, np.ndarray]]]] = [[] for _ in range(R)]
    sends: dict[tuple[int, int], list[tuple[int, dict[str, np.ndarray]]]] = {}
    leaves: dict[int, int] | None = None  # bid -> owner, built lazily (periodic)
    moved = 0
    for r in range(R):
        local = forest.local_blocks(r)
        for bid in sorted(local):
            blk = local[bid]
            p = blk.data.get(name)
            if num_particles(p) == 0:
                continue
            lo, hi = block_box(geom, bid)
            # hot-path skip: everything still in-box needs no boundary
            # handling (the domain boundary is unreachable from inside the
            # block box) and no rewrite — interior blocks cost nothing
            if bool(np.all((p["pos"] >= lo) & (p["pos"] < hi))):
                continue
            pos, vel = apply_domain_boundary(p["pos"], p["vel"], hi_dom, boundary)
            inside = np.all((pos >= lo) & (pos < hi), axis=1)
            updated = {"pos": pos, "vel": vel, "id": p["id"]}
            if bool(inside.all()):
                blk.data[name] = updated
                continue
            # assign each leaver to the adjacent leaf containing it
            target = np.full(pos.shape[0], -1, dtype=np.int64)
            owner_of: dict[int, int] = {}
            unresolved = ~inside
            for nbid in sorted(blk.neighbors):
                if not unresolved.any():
                    break
                nlo, nhi = block_box(geom, nbid)
                m = unresolved & np.all((pos >= nlo) & (pos < nhi), axis=1)
                if m.any():
                    target[m] = nbid
                    owner_of[nbid] = blk.neighbors[nbid]
                    unresolved &= ~m
            if unresolved.any():
                # periodic wrap: the containing leaf is across the domain —
                # not a neighbor. Route via the global leaf map (simulated
                # fabric; real periodic meshes carry periodic adjacency).
                if boundary == "periodic":
                    if leaves is None:
                        leaves = {b.bid: b.owner for b in forest.all_blocks()}
                    for i in np.flatnonzero(unresolved):
                        t = find_leaf(geom, leaves, pos[i])
                        assert t is not None, f"particle {p['id'][i]} left the domain"
                        target[i] = t
                        owner_of[t] = leaves[t]
                    unresolved[:] = False
                else:
                    ids = p["id"][unresolved]
                    raise AssertionError(
                        f"particles {ids[:8].tolist()} of block {bid:#x} moved "
                        "beyond the neighbor shell in one step (CFL violated?)"
                    )
            blk.data[name] = take(updated, inside)
            for nbid in np.unique(target[target >= 0]):
                nbid = int(nbid)
                m = target == nbid
                payload = take(updated, m)
                moved += int(m.sum())
                dst = owner_of[nbid]
                if dst == r:
                    deliveries[r].append((nbid, payload))
                else:
                    sends.setdefault((r, dst), []).append((nbid, payload))
    cross_bytes = 0
    if sends:
        for (src, dst), items in sorted(sends.items()):
            nbytes = sum(BYTES_BLOCK_ID + payload_nbytes(pl) for _b, pl in items)
            cross_bytes += nbytes
            comm.send(src, dst, "part", items, nbytes=nbytes)
        inbox = comm.exchange()
        for dst, msgs in inbox.items():
            for _tag, items in msgs:
                deliveries[dst].extend(items)
    for r in range(R):
        local = forest.local_blocks(r)
        for bid, payload in deliveries[r]:
            blk = local[bid]
            blk.data[name] = sort_by_id(
                concat_particles([blk.data.get(name) or empty_particles(), payload])
            )
    return moved, cross_bytes
