"""Non-invasive fault tolerance via redundant in-memory snapshots (paper §4.2).

During snapshot creation every rank X serializes its own blocks and sends a
copy to its *buddy* rank Y = (X + N/2) mod N — pairwise point-to-point
communication only, no disk I/O. The snapshot occupies half the memory
(paper: "leaving only 1/3 of the available memory to the actual simulation"
when counting both own-state and buddy-state copies).

On failure of a process set F, the survivors restore their own saved state;
for every failed rank its buddy additionally restores the failed rank's
blocks. Restoration is immediately followed by one AMR cycle (force-
rebalance) that re-balances the simulation on the surviving ranks. Up to
half of all ranks can fail simultaneously, as long as no buddy pair fails
together — exactly the paper's best-case bound.

The underlying MPI would be a ULFM-style fault-tolerant MPI [5]; the fabric
here simulates the failure notification by constructing the shrunken world.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field

from .comm import Comm
from .forest import Block, BlockForest
from .migration import BlockDataRegistry, payload_nbytes
from .pipeline import AMRPipeline

__all__ = ["ResilienceManager", "BuddySnapshot"]


@dataclass
class BuddySnapshot:
    """Per-rank snapshot storage: own state + buddy's state (both serialized)."""

    own: dict[int, tuple[dict, dict]] = field(default_factory=dict)
    buddy_rank: int = -1
    buddy: dict[int, tuple[dict, dict]] = field(default_factory=dict)

    def nbytes(self) -> int:
        return payload_nbytes(self.own) + payload_nbytes(self.buddy)


class ResilienceManager:
    def __init__(self, registry: BlockDataRegistry):
        self.registry = registry
        self.snapshots: list[BuddySnapshot] = []

    # -- snapshot creation ------------------------------------------------------
    def snapshot(self, forest: BlockForest, comm: Comm) -> None:
        N = forest.nranks
        self.snapshots = [BuddySnapshot() for _ in range(N)]
        for r in range(N):
            state: dict[int, tuple[dict, dict]] = {}
            for bid, blk in forest.local_blocks(r).items():
                meta = {
                    "bid": blk.bid,
                    "level": blk.level,
                    "weight": blk.weight,
                    "neighbors": dict(blk.neighbors),
                }
                state[bid] = (meta, self.registry.encode_block(blk))
            self.snapshots[r].own = state
            buddy = (r + N // 2) % N
            self.snapshots[r].buddy_rank = buddy
            # ship a copy to the buddy (pairwise point-to-point)
            comm.send(r, buddy, "snap", (r, state), nbytes=payload_nbytes(state))
        inbox = comm.exchange()
        for dst, msgs in inbox.items():
            for _tag, (src, state) in msgs:
                # buddy stores the *source's* state redundantly
                self.snapshots[dst].buddy = state
                self.snapshots[dst].buddy_of = src  # type: ignore[attr-defined]

    # -- failure + restore --------------------------------------------------------
    def fail_and_restore(
        self,
        forest: BlockForest,
        failed: set[int],
        pipeline: AMRPipeline,
    ) -> tuple[BlockForest, Comm]:
        """Simulate failure of ``failed`` ranks and restore on the survivors.

        Returns the restored, re-balanced forest on N-|F| ranks and the new
        (shrunken) communicator.
        """
        N = forest.nranks
        assert self.snapshots, "no snapshot taken"
        survivors = [r for r in range(N) if r not in failed]
        assert survivors, "all ranks failed"
        for f in failed:
            buddy = (f + N // 2) % N
            assert buddy not in failed, (
                f"buddy pair ({f},{buddy}) failed together — snapshot lost"
            )
        new_rank_of = {old: new for new, old in enumerate(survivors)}
        new_n = len(survivors)
        restored = BlockForest(forest.geom, new_n)

        def rebuild(state: dict, owner_new: int) -> None:
            for bid, (meta, payload) in state.items():
                blk = Block(
                    bid=meta["bid"],
                    level=meta["level"],
                    owner=owner_new,
                    weight=meta["weight"],
                )
                # copy: the snapshot must survive the restored run mutating
                # its blocks in place (a second restore must stay valid)
                blk.data = self.registry.decode_block(payload, blk, copy=True)
                restored.insert(blk)

        for old in survivors:
            rebuild(self.snapshots[old].own, new_rank_of[old])
        for f in failed:
            buddy = (f + N // 2) % N
            rebuild(self.snapshots[buddy].buddy, new_rank_of[buddy])

        # neighbor owner maps must be remapped to the shrunken world; owners
        # of restored failed-rank blocks changed to their buddy. Rebuild the
        # owner info from the restored forest's own records (each block knows
        # its neighbors' ids from the snapshot meta; owners are re-derived).
        owner_of = {b.bid: b.owner for b in restored.all_blocks()}
        for b in restored.all_blocks():
            meta_neighbors = None
            # find neighbor ids from whichever snapshot carried this block
            for snap in self.snapshots:
                if b.bid in snap.own:
                    meta_neighbors = snap.own[b.bid][0]["neighbors"]
                    break
            assert meta_neighbors is not None
            b.neighbors = {nb: owner_of[nb] for nb in meta_neighbors}

        # "immediately followed by the execution of one AMR cycle that ensures
        #  load balance of the simulation on fewer processes"
        comm = Comm(new_n)
        restored, _report = pipeline.run_cycle(
            restored, comm, mark_fn=None, force_rebalance=True
        )
        return restored, comm
