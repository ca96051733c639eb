"""The diffusion balancer with its block selection indexed: the copied
:class:`~.core.balancing.DiffusionBalancer`'s assignments, bit for bit, at a
cost that grows with the blocks a rank holds and not with their product.

The copy's push scheme (paper Alg. 3) picks each block to move by scanning
every local block and recomputing its connection strengths, face, edge and
corner contacts found from the block ids' boxes (``geom.adjacency_kind``).
At the card's scale (6,768 blocks) that took 117-180 s of an AMR event's
host time beside an H100 (PERF.md section 6), nearly all of it in
``adjacency_kind``. Here the contact strength of a pair of block ids, a
function of the two ids alone, is kept for the balancing cycle; each push
builds a rank's strengths once and, when it marks a block, moves that
block's contact from its local neighbours' own-rank sums to their sums for
its owner, as the copy's recomputation would find. The strengths are
small integers (4, 2, 1) and their sums exact in float64, so every score,
every tie and every choice equals the copy's. The pull scheme keeps the
copy's code and reads the kept strengths.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .core.balancing import DiffusionBalancer
from .core.balancing.diffusion import _EPS, _STRENGTH
from .core.forest import BlockForest

__all__ = ["IndexedDiffusionBalancer"]


class _KeptKinds:
    """``geom`` with ``adjacency_kind`` kept per pair of block ids."""

    def __init__(self, geom, kinds: dict) -> None:
        self._geom = geom
        self._kinds = kinds

    def adjacency_kind(self, a: int, b: int) -> str:
        key = (a, b)
        kind = self._kinds.get(key)
        if kind is None:
            kind = self._kinds[key] = self._geom.adjacency_kind(a, b)
        return kind

    def __getattr__(self, name):
        return getattr(self._geom, name)


@dataclass
class IndexedDiffusionBalancer(DiffusionBalancer):
    """:class:`~.core.balancing.DiffusionBalancer` whose push builds each
    rank's connection strengths once a call and updates them as it marks
    blocks, and whose contact kinds are kept for a balancing cycle (cleared
    at its first main iteration)."""

    _kinds: dict = field(default_factory=dict, init=False, repr=False)

    def __call__(self, proxy: BlockForest, comm, iteration: int):
        if iteration == 0:
            self._kinds.clear()
        return super().__call__(proxy, comm, iteration)

    def _pull(self, proxy, comm, geom, *args, **kwargs) -> None:
        super()._pull(proxy, comm, _KeptKinds(geom, self._kinds), *args, **kwargs)

    def _push(self, proxy, geom, r, flow, levels, out, w_r=None, avg=None, w_nb0=None) -> None:
        kind = _KeptKinds(geom, self._kinds).adjacency_kind
        local = proxy.local_blocks(r)
        # per local block: its strength to each owner of a neighbour that is
        # not an unmarked local block (s), to its unmarked local neighbours
        # (own), and, per local neighbour, the contact and the owner the
        # block records for it (the copy's _connection_strengths, kept)
        s: dict[int, dict[int, float]] = {}
        own: dict[int, float] = {}
        held_by: dict[int, list[tuple[int, float, int]]] = {}
        for bid, blk in local.items():
            to_rank: dict[int, float] = {}
            mine = 0.0
            for nb, owner in blk.neighbors.items():
                k = _STRENGTH[kind(bid, nb)]
                if nb in local:
                    mine += k
                    held_by.setdefault(nb, []).append((bid, k, owner))
                else:
                    to_rank[owner] = to_rank.get(owner, 0.0) + k
            s[bid] = to_rank
            own[bid] = mine
        marked: set[int] = set()

        def mark(bid: int) -> None:
            marked.add(bid)
            for other, k, owner in held_by.get(bid, ()):
                own[other] -= k
                s[other][owner] = s[other].get(owner, 0.0) + k

        for li in range(len(levels)):
            f = {j: fl[li] for j, fl in flow.items()}
            outflow = sum(v for v in f.values() if v > 0)
            if avg is not None:
                outflow = min(outflow, max(0.0, w_r[li] - avg[li]))
            candidates = [(bid, blk.weight) for bid, blk in local.items()
                          if not (self.per_level and blk.level != li)]
            while outflow > _EPS and any(v > _EPS for v in f.values()):
                j = max(f, key=lambda k: f[k])
                if f[j] <= _EPS:
                    break
                gap_cap = None
                if avg is not None and w_nb0 is not None and j in w_nb0:
                    gap_cap = (w_r[li] - w_nb0[j][li]) / 2.0
                best = None
                best_score = None
                for bid, weight in candidates:
                    if bid in marked or weight > outflow + _EPS:
                        continue
                    if gap_cap is not None and weight > gap_cap + _EPS:
                        continue
                    score = s[bid].get(j, 0.0) - own[bid]
                    if best_score is None or score > best_score:
                        best, best_score = bid, score
                if best is None:
                    f[j] = 0.0
                    continue
                weight = local[best].weight
                mark(best)
                out[best] = j
                f[j] -= weight
                outflow -= weight
