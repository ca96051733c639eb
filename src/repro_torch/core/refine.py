"""Distributed block-level refinement & coarsening with 2:1 balance (paper §2.2).

Two-step phase:

1. An application callback assigns a *wish* target level to every local block
   (perfectly distributed, no communication).
2. The framework enforces 2:1 balance with neighbor-only exchanges:
   - all refinement wishes are accepted;
   - additional blocks are iteratively *forced to split*;
   - coarsening wishes are accepted iff all 8 siblings wish to merge and the
     merged block would not violate 2:1 against the neighbors' target levels
     (iterative, so accepted merges can enable further merges — Fig. 2 (3,4)).

Sibling groups may span ranks: all 8 siblings are mutually corner-adjacent,
so the vote/decision traffic is next-neighbor only. The iteration count is
bounded by the number of levels in use (paper §2.2); two global reductions of
one boolean implement the early-exit optimization.

The function returns the per-rank ghost view of neighbor target levels, which
the proxy construction (§2.3) reuses.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Mapping

from .blockid import octant_of, parent_id, sibling_ids
from .comm import BYTES_BLOCK_ID, BYTES_LEVEL, BYTES_RANK, Comm
from .forest import Block, BlockForest

__all__ = ["mark_and_balance_targets", "MarkCallback"]

# callback: (rank, local blocks) -> {bid: wished target level}
MarkCallback = Callable[[int, Mapping[int, Block]], Mapping[int, int] | None]


def _exchange_targets(forest: BlockForest, comm: Comm) -> list[dict[int, int]]:
    """One neighbor-exchange round of (bid, target_level) for boundary blocks.

    Returns per-rank ghost maps {neighbor bid -> its current target level}.
    """
    nbytes_item = BYTES_BLOCK_ID + BYTES_LEVEL
    for r in range(forest.nranks):
        per_dst: dict[int, list[tuple[int, int]]] = defaultdict(list)
        for bid, blk in forest.local_blocks(r).items():
            for owner in set(blk.neighbors.values()):
                if owner != r:
                    per_dst[owner].append((bid, blk.target_level))
        for dst, items in per_dst.items():
            comm.send(r, dst, "tgt", items, nbytes=len(items) * nbytes_item)
    inbox = comm.exchange()
    ghost: list[dict[int, int]] = [dict() for _ in range(forest.nranks)]
    for dst, msgs in inbox.items():
        for _tag, items in msgs:
            for bid, t in items:
                ghost[dst][bid] = t
    return ghost


def mark_and_balance_targets(
    forest: BlockForest,
    comm: Comm,
    mark_fn: MarkCallback | None,
) -> tuple[bool, list[dict[int, int]]]:
    """Run the full §2.2 phase. Sets ``blk.target_level`` on every block.

    Returns ``(levels_changed, ghost_targets)`` where ``ghost_targets[r]``
    maps every remote neighbor bid of rank ``r`` to its final target level.
    """
    R = forest.nranks

    # -- step 1: application-dependent callback (distributed, no comm) -------
    wish: list[dict[int, int]] = [dict() for _ in range(R)]
    for r in range(R):
        local = forest.local_blocks(r)
        answers = dict(mark_fn(r, local)) if mark_fn is not None else {}
        for bid, blk in local.items():
            w = int(answers.get(bid, blk.level))
            wish[r][bid] = max(blk.level - 1, min(blk.level + 1, w))
            # phase A initialization: accept splits, treat coarsen wishes as
            # "keep" until they are accepted by the merge protocol below.
            blk.target_level = blk.level + 1 if wish[r][bid] > blk.level else blk.level

    # -- early-exit reduction #1 (paper §2.2) ---------------------------------
    any_marked = comm.allreduce(
        (
            any(w != forest.local_blocks(r)[bid].level for bid, w in wish[r].items())
            for r in range(R)
        ),
        lambda a, b: a or b,
        nbytes=1,
    )
    if not any_marked:
        return False, _exchange_targets(forest, comm)

    # -- phase A: iterative forced splits to maintain 2:1 ---------------------
    ghost: list[dict[int, int]] = [dict() for _ in range(R)]
    while True:
        ghost = _exchange_targets(forest, comm)
        changed = False
        for r in range(R):
            g = ghost[r]
            local = forest.local_blocks(r)
            for bid, blk in local.items():
                nb_max = blk.target_level
                for nb in blk.neighbors:
                    t = g.get(nb)
                    if t is None:  # local neighbor
                        t = local[nb].target_level
                    if t > nb_max:
                        nb_max = t
                forced = nb_max - 1
                if forced > blk.target_level:
                    assert forced <= blk.level + 1, "2:1 precondition violated"
                    blk.target_level = forced
                    changed = True
        if not comm.allreduce([changed] * R, lambda a, b: a or b, nbytes=1):
            break

    # -- phase B: iterative coarsening acceptance ------------------------------
    # A block is a merge candidate while: it wishes to coarsen, was not forced
    # to split, and is not yet accepted (acceptance lowers target_level).
    while True:
        ghost = _exchange_targets(forest, comm)
        # round 1: votes to the designated sibling owner (min bid in group)
        for r in range(R):
            g = ghost[r]
            local = forest.local_blocks(r)
            for bid, blk in local.items():
                if wish[r][bid] >= blk.level or blk.target_level != blk.level:
                    continue
                sibs = sibling_ids(bid)
                if not all(s == bid or s in blk.neighbors for s in sibs):
                    continue  # some sibling area is refined -> group invalid
                external_ok = True
                for nb in blk.neighbors:
                    if nb in sibs:
                        continue
                    t = g.get(nb)
                    if t is None:
                        t = local[nb].target_level
                    if t > blk.level:  # merged block would be at level-1
                        external_ok = False
                        break
                designated = min(sibs)
                dst = r if designated == bid else blk.neighbors[designated]
                # the vote carries the voter's neighbor meta for §2.3 reuse
                comm.send(
                    r,
                    dst,
                    "vote",
                    (parent_id(bid), octant_of(bid), external_ok, r),
                    nbytes=BYTES_BLOCK_ID + 1 + 1 + BYTES_RANK,
                )
        inbox = comm.exchange()
        votes: dict[int, dict[int, list[tuple[int, bool, int]]]] = defaultdict(
            lambda: defaultdict(list)
        )
        for dst, msgs in inbox.items():
            for _tag, (pid, oct_, ok, src) in msgs:
                votes[dst][pid].append((oct_, ok, src))
        # round 2: decisions back to the sibling owners
        for dst, groups in votes.items():
            for pid, vs in groups.items():
                if len({o for o, _, _ in vs}) == 8 and all(ok for _, ok, _ in vs):
                    for oct_, _, src in vs:
                        comm.send(
                            dst, src, "accept", (pid, oct_), nbytes=BYTES_BLOCK_ID + 1
                        )
        inbox = comm.exchange()
        changed = False
        for dst, msgs in inbox.items():
            local = forest.local_blocks(dst)
            for _tag, (pid, oct_) in msgs:
                bid = (pid << 3) | oct_
                blk = local[bid]
                if blk.target_level == blk.level:
                    blk.target_level = blk.level - 1
                    changed = True
        if not comm.allreduce([changed] * R, lambda a, b: a or b, nbytes=1):
            break

    # -- early-exit reduction #2 (paper §2.2) ---------------------------------
    levels_changed = comm.allreduce(
        (
            any(b.target_level != b.level for b in forest.local_blocks(r).values())
            for r in range(R)
        ),
        lambda a, b: a or b,
        nbytes=1,
    )
    ghost = _exchange_targets(forest, comm)
    return bool(levels_changed), ghost
