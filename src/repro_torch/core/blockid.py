"""Octree block identification scheme (paper §2, cf. p4est [12] / waLBerla).

A *forest of octrees* partitions the domain: a Cartesian root grid of
``(rx, ry, rz)`` root blocks, each root the root of an octree. Every block is
identified by a single integer ID built from a marker bit, the root index,
and 3 bits per level (the octant path):

    root id            = (1 << root_bits) | root_index
    child(id, octant)  = (id << 3) | octant          octant = x | y<<1 | z<<2
    parent(id)         = id >> 3
    level(id)          = (bit_length(id) - 1 - root_bits) // 3

The tree structure is therefore *implicit* in the IDs — it is never stored
explicitly (paper §2: "the resulting tree structure is not stored explicitly,
but it is implicitly defined by a unique identification scheme").

Sorting blocks by the :func:`morton_key` yields a depth-first Morton (z-curve)
ordering; :func:`hilbert_key` yields Hilbert order via Skilling's transpose
algorithm.  Both keys left-align the path bits at ``max_level`` so blocks of
different levels interleave correctly along the curve.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Iterator

__all__ = [
    "ForestGeometry",
    "octant_of",
    "child_id",
    "parent_id",
    "sibling_ids",
    "morton_key",
    "hilbert_key",
    "hilbert_index_3d",
]


def _bits_for(n: int) -> int:
    """Number of bits needed to represent indices 0..n-1 (at least 1)."""
    return max(1, (max(n - 1, 0)).bit_length())


@dataclass(frozen=True)
class ForestGeometry:
    """Static geometry of the forest: root grid plus octree depth budget.

    All coordinate math is done in *fine units*: the unit grid obtained by
    (conceptually) refining every root block ``max_level`` times. A block at
    level ``l`` covers a cube of side ``2**(max_level - l)`` fine units.
    """

    root_grid: tuple[int, int, int]
    max_level: int = 14  # depth budget; IDs stay < 2**64 for root_bits <= 20

    @property
    def root_bits(self) -> int:
        rx, ry, rz = self.root_grid
        return _bits_for(rx * ry * rz)

    @property
    def num_roots(self) -> int:
        rx, ry, rz = self.root_grid
        return rx * ry * rz

    # -- root index <-> root coordinates ------------------------------------
    def root_index(self, cx: int, cy: int, cz: int) -> int:
        rx, ry, _ = self.root_grid
        return cx + rx * (cy + ry * cz)

    def root_coords(self, root_idx: int) -> tuple[int, int, int]:
        rx, ry, _ = self.root_grid
        return root_idx % rx, (root_idx // rx) % ry, root_idx // (rx * ry)

    # -- id decomposition ----------------------------------------------------
    def root_id(self, root_idx: int) -> int:
        return (1 << self.root_bits) | root_idx

    def level_of(self, bid: int) -> int:
        n = bid.bit_length() - 1 - self.root_bits
        assert n >= 0 and n % 3 == 0, f"malformed block id {bid:#x}"
        return n // 3

    def root_of(self, bid: int) -> int:
        return (bid >> (3 * self.level_of(bid))) & ((1 << self.root_bits) - 1)

    def path_of(self, bid: int) -> tuple[int, ...]:
        """Octant path from root (level 1 first) to the block's own level."""
        level = self.level_of(bid)
        return tuple((bid >> (3 * (level - 1 - k))) & 7 for k in range(level))

    # -- geometry ------------------------------------------------------------
    def block_coords(self, bid: int) -> tuple[int, int, int, int]:
        """(level, x, y, z) with x,y,z the block coords *within its root*
        at the block's level (each in [0, 2**level))."""
        level = self.level_of(bid)
        x = y = z = 0
        for o in self.path_of(bid):
            x = (x << 1) | (o & 1)
            y = (y << 1) | ((o >> 1) & 1)
            z = (z << 1) | ((o >> 2) & 1)
        return level, x, y, z

    def id_from_coords(self, level: int, x: int, y: int, z: int, root_idx: int) -> int:
        bid = self.root_id(root_idx)
        for k in range(level - 1, -1, -1):
            o = ((x >> k) & 1) | (((y >> k) & 1) << 1) | (((z >> k) & 1) << 2)
            bid = (bid << 3) | o
        return bid

    def aabb(self, bid: int) -> tuple[int, int, int, int, int, int]:
        """(x0, y0, z0, x1, y1, z1) of the block in fine units (half-open)."""
        level, x, y, z = self.block_coords(bid)
        rx, ry, rz = self.root_coords(self.root_of(bid))
        side = 1 << (self.max_level - level)
        full = 1 << self.max_level
        x0 = rx * full + x * side
        y0 = ry * full + y * side
        z0 = rz * full + z * side
        return x0, y0, z0, x0 + side, y0 + side, z0 + side

    def adjacent(self, a: int, b: int) -> bool:
        """Face/edge/corner adjacency of two non-overlapping blocks."""
        ax0, ay0, az0, ax1, ay1, az1 = self.aabb(a)
        bx0, by0, bz0, bx1, by1, bz1 = self.aabb(b)
        # closed boxes must intersect in every dimension
        return (
            ax0 <= bx1 and bx0 <= ax1
            and ay0 <= by1 and by0 <= ay1
            and az0 <= bz1 and bz0 <= az1
            and a != b
        )

    def adjacency_kind(self, a: int, b: int) -> str:
        """'face' | 'edge' | 'corner' | 'overlap' | 'none' between two blocks."""
        ax0, ay0, az0, ax1, ay1, az1 = self.aabb(a)
        bx0, by0, bz0, bx1, by1, bz1 = self.aabb(b)
        overlaps = 0
        touches = 0
        for lo_a, hi_a, lo_b, hi_b in (
            (ax0, ax1, bx0, bx1),
            (ay0, ay1, by0, by1),
            (az0, az1, bz0, bz1),
        ):
            if lo_a < hi_b and lo_b < hi_a:
                overlaps += 1
            elif hi_a == lo_b or hi_b == lo_a:
                touches += 1
            else:
                return "none"
        if overlaps == 3:
            return "overlap"
        return {2: "face", 1: "edge", 0: "corner"}[overlaps]

    def in_domain(self, level: int, x: int, y: int, z: int, root_cx: int, root_cy: int, root_cz: int) -> bool:
        rx, ry, rz = self.root_grid
        return 0 <= root_cx < rx and 0 <= root_cy < ry and 0 <= root_cz < rz

    def neighbor_region_ids(self, bid: int, dx: int, dy: int, dz: int) -> int | None:
        """ID of the same-level neighbor block in direction (dx,dy,dz) (each in
        {-1,0,+1}), or None if outside the domain. Crosses root boundaries."""
        level, x, y, z = self.block_coords(bid)
        rcx, rcy, rcz = self.root_coords(self.root_of(bid))
        n = 1 << level
        nx, ny, nz = x + dx, y + dy, z + dz
        if nx < 0:
            rcx -= 1
            nx += n
        elif nx >= n:
            rcx += 1
            nx -= n
        if ny < 0:
            rcy -= 1
            ny += n
        elif ny >= n:
            rcy += 1
            ny -= n
        if nz < 0:
            rcz -= 1
            nz += n
        elif nz >= n:
            rcz += 1
            nz -= n
        rx, ry, rz = self.root_grid
        if not (0 <= rcx < rx and 0 <= rcy < ry and 0 <= rcz < rz):
            return None
        return self.id_from_coords(level, nx, ny, nz, self.root_index(rcx, rcy, rcz))

    # -- SFC keys --------------------------------------------------------------
    def morton_key(self, bid: int) -> tuple[int, int, int]:
        """Depth-first Morton key: (root, left-aligned path, level)."""
        level = self.level_of(bid)
        path = bid & ((1 << (3 * level)) - 1)
        return (self.root_of(bid), path << (3 * (self.max_level - level)), level)

    def hilbert_key(self, bid: int) -> tuple[int, int, int]:
        """Depth-first Hilbert key (per-root curve, roots in index order)."""
        level, x, y, z = self.block_coords(bid)
        h = hilbert_index_3d(max(level, 1), x, y, z) if level > 0 else 0
        return (self.root_of(bid), h << (3 * (self.max_level - level)), level)


# -- plain-int helpers (geometry-free) ------------------------------------------


def octant_of(bid: int) -> int:
    """Octant of a (non-root) block within its parent."""
    return bid & 7


def child_id(bid: int, octant: int) -> int:
    return (bid << 3) | octant


def parent_id(bid: int) -> int:
    return bid >> 3


def sibling_ids(bid: int) -> tuple[int, ...]:
    """All 8 ids sharing this block's parent (includes bid itself)."""
    base = (bid >> 3) << 3
    return tuple(base | o for o in range(8))


def children_ids(bid: int) -> tuple[int, ...]:
    return tuple((bid << 3) | o for o in range(8))


# -- Hilbert curve (Skilling's transpose algorithm, 3D) --------------------------


def hilbert_index_3d(nbits: int, x: int, y: int, z: int) -> int:
    """Hilbert index of cell (x, y, z) on a 2**nbits cube grid.

    Implements J. Skilling, "Programming the Hilbert curve" (AIP 2004):
    AxesToTranspose followed by bit interleaving. O(nbits), no lookup tables
    (cf. paper §2.4.1 [14] — tables exist; the arithmetic form is equivalent).
    """
    X = [x, y, z]
    n = 3
    m = 1 << (nbits - 1)
    # Inverse undo excess work
    q = m
    while q > 1:
        p = q - 1
        for i in range(n):
            if X[i] & q:
                X[0] ^= p
            else:
                t = (X[0] ^ X[i]) & p
                X[0] ^= t
                X[i] ^= t
        q >>= 1
    # Gray encode
    for i in range(1, n):
        X[i] ^= X[i - 1]
    t = 0
    q = m
    while q > 1:
        if X[n - 1] & q:
            t ^= q - 1
        q >>= 1
    for i in range(n):
        X[i] ^= t
    # Interleave: bit (nbits-1-b) of X[i] becomes bit (3*(nbits-1-b) + (2-i))
    h = 0
    for b in range(nbits - 1, -1, -1):
        for i in range(n):
            h = (h << 1) | ((X[i] >> b) & 1)
    return h


ALL_DIRECTIONS: tuple[tuple[int, int, int], ...] = tuple(
    d for d in itertools.product((-1, 0, 1), repeat=3) if d != (0, 0, 0)
)
