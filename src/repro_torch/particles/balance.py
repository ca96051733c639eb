"""Particle-aware load model for dynamic balancing (cf. Nanda et al. 2025).

With mesh-only LBM every block costs the same (paper §3.2) and the balancers
only ever see ``weight = 1.0``. Tracers break that: a block's work is its
cell count plus a per-particle advection/redistribution cost, so the load
model becomes::

    weight(block) = nx*ny*nz + alpha * num_particles(block)

Two hooks plug this into the AMR pipeline:

* :func:`particle_block_weight` — a
  :data:`~repro.core.pipeline.BlockWeightFn` evaluated on actual blocks;
  the pipeline reevaluates it before every balancing cycle and again after
  migration, so refined/coarsened/migrated blocks always carry weights
  derived from their actual particle content;
* :func:`particle_proxy_weight` — a :data:`~repro.core.proxy.ProxyWeightFn`
  for the in-cycle estimates: keeps are exact, split children count the
  particles in their octant exactly (mid-plane partition of the parent's
  set), merges estimate the octet as 8x the designated sibling's count (the
  other seven live on other ranks; the post-migration reevaluation replaces
  the estimate with the exact merged count).
"""

from __future__ import annotations

import math

from ..core.blockid import octant_of
from ..core.forest import Block
from ..core.pipeline import BlockWeightFn
from ..core.proxy import ProxyWeightFn

from .storage import num_particles, octant_index

__all__ = ["particle_block_weight", "particle_proxy_weight"]


def particle_block_weight(
    cells: tuple[int, int, int],
    alpha: float,
    name: str = "particles",
) -> BlockWeightFn:
    ncells = float(math.prod(cells))

    def weight(blk: Block) -> float:
        return ncells + alpha * num_particles(blk.data.get(name))

    return weight


def particle_proxy_weight(
    geom,
    cells: tuple[int, int, int],
    alpha: float,
    name: str = "particles",
) -> ProxyWeightFn:
    ncells = float(math.prod(cells))

    def weight(old: Block, kind: str, new_bid: int) -> float:
        p = old.data.get(name)
        n = num_particles(p)
        if kind == "split" and n:
            o = octant_of(new_bid)
            n = int((octant_index(geom, old.bid, p["pos"]) == o).sum())
        elif kind == "merge":
            n = 8 * n  # estimate: only the designated sibling is visible
        return ncells + alpha * n

    return weight
