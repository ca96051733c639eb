from __future__ import annotations

from typing import Protocol

from ..comm import Comm
from ..forest import BlockForest

__all__ = ["Balancer", "max_level_in_use", "is_balanced_per_level"]


class Balancer(Protocol):
    def __call__(
        self, proxy: BlockForest, comm: Comm, iteration: int
    ) -> tuple[list[dict[int, int]], bool]:
        """Return (per-rank {bid: target rank}, run-another-iteration)."""
        ...


def max_level_in_use(proxy: BlockForest, comm: Comm) -> int:
    """Global max block level — one small allreduce."""
    per_rank = [
        max((b.level for b in proxy.local_blocks(r).values()), default=0)
        for r in range(proxy.nranks)
    ]
    return comm.allreduce(per_rank, max, nbytes=1)


def is_balanced_per_level(
    proxy: BlockForest, comm: Comm, levels: range, tolerance: float = 0.0
) -> bool:
    """Global check: every level's max per-rank weight is within the perfect-
    balance bound (ceil of the average for unit weights; (1+tol)·avg plus one
    block granularity otherwise). Costs one allreduce (paper §2.4.2: the
    second optional global reduction enabling early termination)."""
    R = proxy.nranks
    stats: list[list[tuple[float, float, float]]] = []
    for r in range(R):
        per_level = []
        for lvl in levels:
            ws = [b.weight for b in proxy.local_blocks(r).values() if b.level == lvl]
            per_level.append((sum(ws), max(ws, default=0.0), float(len(ws))))
        stats.append(per_level)

    def combine(a, b):
        return [
            (wa + wb, max(ma, mb), ca + cb)
            for (wa, ma, ca), (wb, mb, cb) in zip(a, b)
        ]

    totals = comm.allreduce(stats, combine, nbytes=8 * 3 * len(levels))
    for (total_w, max_blk_w, count), li in zip(totals, levels):
        if count == 0:
            continue
        avg = total_w / R
        # perfect balance bound: no rank above the unavoidable granularity
        bound = avg * (1.0 + tolerance) + max_blk_w * (1.0 - 1.0 / max(R, 1)) + 1e-9
        max_w = max(
            sum(b.weight for b in proxy.local_blocks(r).values() if b.level == li)
            for r in range(R)
        )
        if max_w > bound:
            return False
    return True
