"""Distributed block forest (paper §2): rank-local block storage + ghost info.

Every rank stores *only* its own blocks. For each local block it additionally
knows the IDs and owner ranks of all spatially adjacent blocks (face, edge,
or corner — the distributed adjacency graph of §2). There is no replicated
global meta data: the per-rank memory is O(local blocks), independent of the
total number of ranks — the paper's central scalability property, asserted by
:func:`metadata_bytes_per_rank` and measured in ``benchmarks/metadata_sync.py``.

Forest *initialization* constructs the initial partition globally (as does
waLBerla's setup phase); every later modification (refinement, balancing,
migration) is performed by the distributed algorithms in
:mod:`repro.core.refine` / :mod:`repro.core.balancing` /
:mod:`repro.core.migration` using only rank-local state and messages.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator

from .blockid import ALL_DIRECTIONS, ForestGeometry, children_ids, parent_id
from .comm import BYTES_BLOCK_ID, BYTES_LEVEL, BYTES_RANK, BYTES_WEIGHT

__all__ = ["Block", "BlockForest", "make_uniform_forest", "make_forest_from_levels"]


@dataclass
class Block:
    """A rank-local block. ``data`` holds named simulation payloads (actual
    forest); proxy blocks leave it empty and use the link fields instead."""

    bid: int
    level: int
    owner: int
    neighbors: dict[int, int] = field(default_factory=dict)  # bid -> owner rank
    weight: float = 1.0
    # refinement marking state (§2.2): effective target level
    target_level: int | None = None
    # bilateral proxy<->actual links (§2.3):
    #   on actual blocks: target rank per new block (1 for keep/move-or-merge, 8 for split)
    #   on proxy blocks: source rank per constituent actual block (8 for merge)
    target_ranks: list[int] = field(default_factory=list)
    source_ranks: list[int] = field(default_factory=list)
    data: dict[str, Any] = field(default_factory=dict)

    def clone_shallow(self) -> "Block":
        return Block(
            bid=self.bid,
            level=self.level,
            owner=self.owner,
            neighbors=dict(self.neighbors),
            weight=self.weight,
        )

    def meta_nbytes(self) -> int:
        """Approximate serialized meta-data size (paper §2.4: 'a few bytes')."""
        return (
            BYTES_BLOCK_ID
            + BYTES_LEVEL
            + BYTES_RANK
            + BYTES_WEIGHT
            + len(self.neighbors) * (BYTES_BLOCK_ID + BYTES_RANK)
            + (len(self.source_ranks) + len(self.target_ranks)) * BYTES_RANK
        )


class BlockForest:
    """Rank-partitioned forest: ``ranks[r]`` maps bid -> Block for rank r."""

    def __init__(self, geom: ForestGeometry, nranks: int):
        self.geom = geom
        self.nranks = nranks
        self.ranks: list[dict[int, Block]] = [dict() for _ in range(nranks)]

    # -- rank-local access (what the distributed algorithms use) ----------------
    def local_blocks(self, rank: int) -> dict[int, Block]:
        return self.ranks[rank]

    def neighbor_ranks(self, rank: int) -> set[int]:
        """Process graph neighbors of ``rank`` (paper §2.4.2)."""
        out: set[int] = set()
        for blk in self.ranks[rank].values():
            out.update(r for r in blk.neighbors.values() if r != rank)
        return out

    def insert(self, blk: Block) -> None:
        self.ranks[blk.owner][blk.bid] = blk

    def remove(self, rank: int, bid: int) -> Block:
        return self.ranks[rank].pop(bid)

    # -- whole-forest iteration (verification / setup / data-plane export) ------
    def all_blocks(self) -> Iterator[Block]:
        for rank_blocks in self.ranks:
            yield from rank_blocks.values()

    def num_blocks(self) -> int:
        return sum(len(r) for r in self.ranks)

    def blocks_per_rank(self, level: int | None = None) -> list[int]:
        if level is None:
            return [len(r) for r in self.ranks]
        return [sum(1 for b in r.values() if b.level == level) for r in self.ranks]

    def weights_per_rank(self, level: int | None = None) -> list[float]:
        return [
            sum(b.weight for b in r.values() if level is None or b.level == level)
            for r in self.ranks
        ]

    def levels_in_use(self) -> list[int]:
        return sorted({b.level for b in self.all_blocks()})

    def metadata_bytes_per_rank(self) -> list[int]:
        return [sum(b.meta_nbytes() for b in r.values()) for r in self.ranks]

    # -- invariants (test/verification only: global scans) ----------------------
    def check_leaf_cover(self) -> None:
        """Leaves cover the domain exactly: total volume matches and no block
        is an ancestor of another (octree leaves can only overlap that way)."""
        geom = self.geom
        total = 0
        ids = sorted(b.bid for b in self.all_blocks())
        assert len(ids) == len(set(ids)), "duplicate block ids"
        for b in self.all_blocks():
            side = 1 << (geom.max_level - b.level)
            total += side**3
        full = (1 << geom.max_level) ** 3 * geom.num_roots
        assert total == full, f"leaf volume {total} != domain volume {full}"
        # ancestor check: for consecutive sorted ids a < b, b descends from a
        # iff shifting b right by 3*(level_b - level_a) gives a.
        by_id = {b.bid: b for b in self.all_blocks()}
        for bid in ids:
            cur = bid >> 3
            while cur >= (1 << geom.root_bits):
                assert cur not in by_id, f"{cur:#x} is an ancestor of {bid:#x}"
                cur >>= 3

    def check_adjacency(self) -> None:
        """Neighbor lists are complete, symmetric, owner-correct, geometric."""
        owner_of = {b.bid: b.owner for b in self.all_blocks()}
        by_id = {b.bid: b for b in self.all_blocks()}
        for b in self.all_blocks():
            for nb, owner in b.neighbors.items():
                assert nb in by_id, f"{b.bid:#x} lists non-leaf neighbor {nb:#x}"
                assert owner == owner_of[nb], f"stale owner for {nb:#x} at {b.bid:#x}"
                assert self.geom.adjacent(b.bid, nb), f"{b.bid:#x} !~ {nb:#x}"
                assert b.bid in by_id[nb].neighbors, f"asymmetric {b.bid:#x}/{nb:#x}"
            # completeness: every leaf geometrically adjacent must be listed
            expected = _geometric_neighbors(self.geom, b.bid, by_id)
            assert expected == set(b.neighbors), (
                f"block {b.bid:#x}: neighbors {sorted(b.neighbors)} != "
                f"expected {sorted(expected)}"
            )

    def check_two_one_balance(self) -> None:
        for b in self.all_blocks():
            by_level = {nb: self.geom.level_of(nb) for nb in b.neighbors}
            for nb, lvl in by_level.items():
                assert abs(lvl - b.level) <= 1, (
                    f"2:1 violated: {b.bid:#x} (L{b.level}) ~ {nb:#x} (L{lvl})"
                )

    def check_all(self) -> None:
        self.check_leaf_cover()
        self.check_adjacency()
        self.check_two_one_balance()


# -- construction -----------------------------------------------------------------


def _geometric_neighbors(geom: ForestGeometry, bid: int, leaves: dict[int, Any]) -> set[int]:
    """All leaves adjacent to ``bid`` given the full leaf map (init/verify only)."""
    out: set[int] = set()
    for dx, dy, dz in ALL_DIRECTIONS:
        same = geom.neighbor_region_ids(bid, dx, dy, dz)
        if same is None:
            continue
        # walk up: the region may be covered by a coarser leaf
        cur = same
        found = False
        while cur.bit_length() > geom.root_bits:
            if cur in leaves:
                out.add(cur)
                found = True
                break
            cur = parent_id(cur)
        if found:
            continue
        # walk down: covered by finer leaves; recurse into touching children
        stack = [same]
        while stack:
            cand = stack.pop()
            if cand in leaves:
                if geom.adjacent(bid, cand):
                    out.add(cand)
                continue
            if geom.level_of(cand) >= geom.max_level:
                continue
            for ch in children_ids(cand):
                if geom.adjacent(bid, ch) or _contains(geom, ch, bid):
                    stack.append(ch)
    out.discard(bid)
    return out


def _contains(geom: ForestGeometry, a: int, b: int) -> bool:
    ax0, ay0, az0, ax1, ay1, az1 = geom.aabb(a)
    bx0, by0, bz0, bx1, by1, bz1 = geom.aabb(b)
    return ax0 <= bx0 and ay0 <= by0 and az0 <= bz0 and ax1 >= bx1 and ay1 >= by1 and az1 >= bz1


def build_adjacency(geom: ForestGeometry, blocks: Iterable[Block]) -> None:
    """(Re)compute neighbor lists for a *complete* block set. Init-time only —
    post-init adjacency is maintained incrementally by the distributed
    algorithms; tests use this as the oracle."""
    by_id = {b.bid: b for b in blocks}
    for b in by_id.values():
        b.neighbors = {
            nb: by_id[nb].owner for nb in _geometric_neighbors(geom, b.bid, by_id)
        }


def make_forest_from_levels(
    geom: ForestGeometry,
    nranks: int,
    leaf_ids: Iterable[int],
    assign: Callable[[int, int], int] | None = None,
    order: str = "morton",
) -> BlockForest:
    """Build a forest from an explicit leaf-id set, distributing blocks along
    the SFC (default Morton) into ``nranks`` equal contiguous chunks — the
    standard static initial partition the paper starts from (Fig. 1)."""
    forest = BlockForest(geom, nranks)
    ids = sorted(leaf_ids, key=geom.morton_key if order == "morton" else geom.hilbert_key)
    n = len(ids)
    blocks = []
    for i, bid in enumerate(ids):
        owner = assign(i, n) if assign else min(nranks - 1, i * nranks // max(1, n))
        blocks.append(Block(bid=bid, level=geom.level_of(bid), owner=owner))
    build_adjacency(geom, blocks)
    for b in blocks:
        forest.insert(b)
    return forest


def make_uniform_forest(
    geom: ForestGeometry, nranks: int, level: int = 0, order: str = "morton"
) -> BlockForest:
    """Uniformly refined forest: every root refined ``level`` times."""
    leaf_ids: list[int] = []
    for root in range(geom.num_roots):
        frontier = [geom.root_id(root)]
        for _ in range(level):
            frontier = [c for b in frontier for c in children_ids(b)]
        leaf_ids.extend(frontier)
    return make_forest_from_levels(geom, nranks, leaf_ids, order=order)
