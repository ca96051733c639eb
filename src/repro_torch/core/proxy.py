"""Lightweight proxy data structure (paper §2.3) and proxy migration (§2.4).

The proxy forest is a shallow, topology-only copy of the actual forest that
conforms to the *target* levels computed in §2.2. Proxy blocks carry no
simulation data — only identity, connectivity, a weight, and the bilateral
links to their actual counterparts:

* each **actual** block stores one target rank per corresponding proxy block
  (8 for a split, 1 otherwise) — ``Block.target_ranks``;
* each **proxy** block stores one source rank per corresponding actual block
  (8 for a merge, 1 otherwise) — ``Block.source_ranks``.

Construction is process-local except for one neighbor exchange of the new
block infos plus one forwarding round for merge groups, so its runtime is
independent of the total number of ranks (paper §2.3).

:func:`migrate_proxy_blocks` is the framework part of the load balancing
stage: it moves proxy blocks to their assigned target ranks — a transfer of
only a few bytes each — while maintaining the bilateral links and the
distributed adjacency (owner ranks) of all neighbors. Misaddressed neighbor
updates (both endpoints moved in the same round) are fixed by one forwarding
round through the previous owner.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable

from .blockid import child_id, children_ids, octant_of, parent_id, sibling_ids
from .comm import BYTES_BLOCK_ID, BYTES_LEVEL, BYTES_RANK, BYTES_WEIGHT, Comm
from .forest import Block, BlockForest

__all__ = ["build_proxy", "migrate_proxy_blocks", "ProxyWeightFn"]

# weight callback: (old actual block, kind, new bid) -> proxy block weight.
ProxyWeightFn = Callable[[Block, str, int], float]


def _default_weight(old: Block, _kind: str, _new_bid: int) -> float:
    """Propagate the actual block's weight onto its proxy successor(s).

    Per-block cost model (paper §3.2: every block stores a grid of the same
    size, so cost is per *block*): split children inherit the parent's
    weight, a merged block the designated sibling's. The old default returned
    a hardcoded 1.0, which silently reset every custom weight — even on
    plain keeps — on each AMR cycle; callers with additive weight semantics
    (e.g. particle counts) should install an explicit weight callback (see
    ``AMRPipeline.block_weight_fn`` / ``repro.particles.balance``)."""
    return old.weight


def build_proxy(
    forest: BlockForest,
    comm: Comm,
    ghost_targets: list[dict[int, int]],
    weight_fn: ProxyWeightFn | None = None,
) -> BlockForest:
    """Create the proxy forest from ``target_level`` and establish links."""
    geom = forest.geom
    R = forest.nranks
    weight_fn = weight_fn or _default_weight
    proxy = BlockForest(geom, R)

    # -- step 1: process-local creation of proxy blocks + links ---------------
    # new_infos[r][old_bid] = [(new_bid, new_owner, kind)]
    new_infos: list[dict[int, list[tuple[int, int, str]]]] = [dict() for _ in range(R)]
    for r in range(R):
        for bid, blk in forest.local_blocks(r).items():
            t = blk.target_level
            assert t is not None, "run mark_and_balance_targets first"
            if t == blk.level:
                blk.target_ranks = [r]
                pb = Block(bid=bid, level=blk.level, owner=r,
                           weight=weight_fn(blk, "keep", bid), source_ranks=[r])
                pb.data["kind"] = "keep"
                proxy.insert(pb)
                new_infos[r][bid] = [(bid, r, "keep")]
            elif t == blk.level + 1:
                blk.target_ranks = [r] * 8
                infos = []
                for ch in children_ids(bid):
                    pb = Block(bid=ch, level=blk.level + 1, owner=r,
                               weight=weight_fn(blk, "split", ch), source_ranks=[r])
                    pb.data["kind"] = "split"
                    proxy.insert(pb)
                    infos.append((ch, r, "split"))
                new_infos[r][bid] = infos
            else:  # merge: all 8 siblings are leaves (guaranteed by §2.2)
                sibs = sibling_ids(bid)
                owners = {
                    s: (r if s == bid else blk.neighbors[s]) for s in sibs
                }
                designated = owners[min(sibs)]
                blk.target_ranks = [designated]
                pid = parent_id(bid)
                if bid == min(sibs):
                    pb = Block(bid=pid, level=blk.level - 1, owner=r,
                               weight=weight_fn(blk, "merge", pid),
                               source_ranks=[owners[child_id(pid, o)] for o in range(8)])
                    pb.data["kind"] = "merge"
                    proxy.insert(pb)
                new_infos[r][bid] = [(pid, designated, "merge")]

    # -- step 2: exchange new-block infos with old-neighbor owners ------------
    nbytes_info = BYTES_BLOCK_ID + BYTES_RANK + BYTES_LEVEL
    for r in range(R):
        per_dst: dict[int, list[tuple[int, list[tuple[int, int, str]]]]] = defaultdict(list)
        for bid, blk in forest.local_blocks(r).items():
            for owner in set(blk.neighbors.values()):
                if owner != r:
                    per_dst[owner].append((bid, new_infos[r][bid]))
        for dst, items in per_dst.items():
            n = sum(len(infos) for _, infos in items)
            comm.send(r, dst, "newinfo", items, nbytes=n * nbytes_info)
    inbox = comm.exchange()
    ghost_new: list[dict[int, list[tuple[int, int, str]]]] = [dict() for _ in range(R)]
    for dst, msgs in inbox.items():
        for _tag, items in msgs:
            for old_bid, infos in items:
                ghost_new[dst][old_bid] = infos

    # -- step 3: per-old-block candidate sets; forward merge candidates -------
    cands: list[dict[int, dict[int, int]]] = [dict() for _ in range(R)]  # old bid -> {new bid: owner}
    for r in range(R):
        local = forest.local_blocks(r)
        for bid, blk in local.items():
            c: dict[int, int] = {}
            for nbid, nowner in blk.neighbors.items():
                infos = (
                    new_infos[r].get(nbid)
                    if nowner == r
                    else ghost_new[r].get(nbid)
                )
                assert infos is not None, f"missing new-info for {nbid:#x}"
                for new_bid, new_owner, _kind in infos:
                    c[new_bid] = new_owner
            for new_bid, new_owner, _kind in new_infos[r][bid]:
                c[new_bid] = new_owner
            cands[r][bid] = c
    # forward merge-group candidates to the designated owner
    for r in range(R):
        for bid, blk in forest.local_blocks(r).items():
            if blk.target_level == blk.level - 1:
                designated = blk.target_ranks[0]
                pid = parent_id(bid)
                payload = (pid, list(cands[r][bid].items()))
                if designated == r:
                    # local: merge directly below
                    cands[r].setdefault(-pid, {}).update(cands[r][bid])
                else:
                    comm.send(r, designated, "mcand", payload,
                              nbytes=len(cands[r][bid]) * (BYTES_BLOCK_ID + BYTES_RANK))
    inbox = comm.exchange()
    for dst, msgs in inbox.items():
        for _tag, (pid, items) in msgs:
            cands[dst].setdefault(-pid, {}).update(dict(items))

    # -- step 4: adjacency of proxy blocks (geometric filter) -----------------
    for r in range(R):
        for pb in proxy.local_blocks(r).values():
            if pb.data["kind"] == "merge":
                c = cands[r].get(-pb.bid, {})
            elif pb.data["kind"] == "split":
                c = cands[r][parent_id(pb.bid)]
            else:
                c = cands[r][pb.bid]
            pb.neighbors = {
                nb: owner
                for nb, owner in c.items()
                if nb != pb.bid and geom.adjacent(pb.bid, nb)
            }
    return proxy


def migrate_proxy_blocks(
    proxy: BlockForest,
    actual: BlockForest,
    comm: Comm,
    assignments: list[dict[int, int]],
) -> int:
    """Framework part of the dynamic load balancing stage (§2.4).

    Moves proxy blocks to their assigned target ranks, updating (a) the
    bilateral links on the actual blocks, (b) the neighbor owner maps of all
    adjacent proxy blocks. Returns the number of migrated blocks.
    """
    R = proxy.nranks
    moved = 0
    move_table: list[dict[int, int]] = [dict() for _ in range(R)]
    local_updates: list[list[tuple[int, int, int]]] = [[] for _ in range(R)]

    for r in range(R):
        targets = assignments[r] if r < len(assignments) else {}
        for bid, tgt in list(targets.items()):
            blk = proxy.local_blocks(r).get(bid)
            if blk is None or tgt == r:
                continue
            moved += 1
            move_table[r][bid] = tgt
            proxy.remove(r, bid)
            blk.owner = tgt
            comm.send(r, tgt, "move", blk, nbytes=blk.meta_nbytes())
            # neighbor owner updates
            for nb, nowner in blk.neighbors.items():
                upd = (nb, bid, tgt)
                if nowner == r:
                    local_updates[r].append(upd)
                else:
                    comm.send(r, nowner, "nbupd", upd,
                              nbytes=2 * BYTES_BLOCK_ID + BYTES_RANK)
            # bilateral link updates on the actual blocks
            kind = blk.data.get("kind", "keep")
            if kind == "keep":
                links = [(bid, 0, blk.source_ranks[0])]
            elif kind == "split":
                links = [(parent_id(bid), octant_of(bid), blk.source_ranks[0])]
            else:  # merge
                links = [(child_id(bid, o), 0, blk.source_ranks[o]) for o in range(8)]
            for abid, idx, src in links:
                comm.send(r, src, "link", (abid, idx, tgt),
                          nbytes=BYTES_BLOCK_ID + BYTES_RANK + 1)

    inbox = comm.exchange()
    forwards: list[tuple[int, int, tuple[int, int, int]]] = []
    for dst, msgs in inbox.items():
        for tag, payload in msgs:
            if tag == "move":
                proxy.insert(payload)
            elif tag == "link":
                abid, idx, tgt = payload
                actual.local_blocks(dst)[abid].target_ranks[idx] = tgt
    # apply neighbor updates (after inserts so moved-in blocks are updatable)
    pending: list[tuple[int, tuple[int, int, int]]] = []
    for dst, msgs in inbox.items():
        for tag, payload in msgs:
            if tag == "nbupd":
                pending.append((dst, payload))
    for r in range(R):
        for upd in local_updates[r]:
            pending.append((r, upd))
    for dst, (nb, bid, tgt) in pending:
        blk = proxy.local_blocks(dst).get(nb)
        if blk is not None:
            blk.neighbors[bid] = tgt
        elif nb in move_table[dst]:  # neighbor moved away this round: forward
            forwards.append((dst, move_table[dst][nb], (nb, bid, tgt)))
        else:
            raise AssertionError(f"nbupd for unknown block {nb:#x} at rank {dst}")
    for src, dst, upd in forwards:
        comm.send(src, dst, "nbupd", upd, nbytes=2 * BYTES_BLOCK_ID + BYTES_RANK)
    inbox = comm.exchange()
    for dst, msgs in inbox.items():
        for _tag, (nb, bid, tgt) in msgs:
            proxy.local_blocks(dst)[nb].neighbors[bid] = tgt
    return moved
