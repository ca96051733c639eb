"""SFC-based dynamic load balancing (paper §2.4.1).

Blocks are globally ordered along a space filling curve (Morton or Hilbert),
the ordered list is split into ``nranks`` contiguous pieces of (approximately)
equal weight, and piece *r* is assigned to rank *r*. For the LBM, blocks must
be balanced **per level** (paper §3.2), which requires one list per level.

The construction of the curve requires a *global* synchronization, realized
as an allgather (paper: "usually best realized with an allgather operation").
The amount of data each rank must then hold follows Table 1:

    per-level? weighted?   bytes allgathered per block (or per rank)
    no         no          1 byte per rank        (block counts only)
    no         yes         1-4  bytes per block   (weights, order preserved)
    yes        no          4-8  bytes per block   (block IDs)
    yes        yes         5-12 bytes per block   (IDs + weights)

This Θ(N) growth in per-rank memory and communication is the scalability
bottleneck measured in §5.1.2/§5.1.4 — reproduced by
``benchmarks/metadata_sync.py`` via the Comm accounting.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..comm import BYTES_BLOCK_ID, BYTES_COUNT, BYTES_WEIGHT, Comm
from ..forest import BlockForest

__all__ = ["SFCBalancer"]


def _split_targets(items: list[tuple], weights: list[float], nranks: int) -> list[int]:
    """Assign sorted items to nranks contiguous chunks of ~equal weight via
    the prefix-midpoint rule (unit weights -> perfect ceil/floor split)."""
    total = sum(weights)
    if total <= 0:
        return [0] * len(items)
    targets = []
    prefix = 0.0
    for w in weights:
        mid = prefix + w / 2.0
        targets.append(min(nranks - 1, int(mid * nranks / total)))
        prefix += w
    return targets


@dataclass
class SFCBalancer:
    """Single-shot global balancer along a Morton or Hilbert curve."""

    order: str = "morton"  # "morton" | "hilbert"
    per_level: bool = True
    weighted: bool = False

    def __call__(
        self, proxy: BlockForest, comm: Comm, iteration: int
    ) -> tuple[list[dict[int, int]], bool]:
        geom = proxy.geom
        R = proxy.nranks
        key = geom.morton_key if self.order == "morton" else geom.hilbert_key

        if not self.per_level:
            # cheap path (Fig. 5, 1.1/1.2): blocks stay in curve order across
            # refinement, so synchronizing per-rank counts (and weights if
            # needed) suffices. Per-rank contribution: local blocks in order.
            contribs = []
            for r in range(R):
                blocks = sorted(proxy.local_blocks(r).values(), key=lambda b: key(b.bid))
                contribs.append([(b.bid, b.weight if self.weighted else 1.0) for b in blocks])
            nbytes_each = (
                BYTES_COUNT
                if not self.weighted
                else BYTES_WEIGHT * max(len(c) for c in contribs)
            )
            gathered = comm.allgather(contribs, nbytes_each=nbytes_each)
            flat: list[tuple[int, float]] = [x for c in gathered for x in c]
            weights = [w for _, w in flat]
            targets = _split_targets(flat, weights, R)
            target_of = {bid: t for (bid, _), t in zip(flat, targets)}
            assignments = [
                {bid: target_of[bid] for bid in proxy.local_blocks(r)} for r in range(R)
            ]
            return assignments, False

        # per-level path: allgather all block IDs (+ weights), reconstruct and
        # split every level's list locally on every rank (Fig. 5, 2.1/2.2).
        contribs = []
        for r in range(R):
            contribs.append(
                [
                    (b.bid, b.weight if self.weighted else 1.0)
                    for b in proxy.local_blocks(r).values()
                ]
            )
        per_block = BYTES_BLOCK_ID + (BYTES_WEIGHT if self.weighted else 0)
        nbytes_each = per_block * max((len(c) for c in contribs), default=0)
        gathered = comm.allgather(contribs, nbytes_each=nbytes_each)
        flat = [x for c in gathered for x in c]
        by_level: dict[int, list[tuple[int, float]]] = {}
        for bid, w in flat:
            by_level.setdefault(geom.level_of(bid), []).append((bid, w))
        target_of = {}
        for lvl, items in by_level.items():
            items.sort(key=lambda bw: key(bw[0]))
            targets = _split_targets(items, [w for _, w in items], R)
            for (bid, _), t in zip(items, targets):
                target_of[bid] = t
        assignments = [
            {bid: target_of[bid] for bid in proxy.local_blocks(r)} for r in range(R)
        ]
        return assignments, False
