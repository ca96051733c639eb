"""Small refined forests for checking ghost fills.

``refined_forest`` grows two roots on a (2, 1, 1) grid and refines the
lowest-id block of each level in turn, so the fused superstep's merged fills
carry ``same``, ``coarse`` and ``fine`` segments. The CPU tests and
``chip_smoke.py`` both build their fill cases from it.
"""

from __future__ import annotations

import numpy as np

from ..core import AMRPipeline, Comm, ForestGeometry, LevelArena, SFCBalancer, make_uniform_forest
from .grid import LBMBlockSpec, make_lbm_fields

__all__ = ["refined_forest"]


def _seed(forest, reg) -> None:
    for b in forest.all_blocks():
        b.data["pdf"] = np.zeros(reg.block_shape("pdf"), np.float32)
        b.data["mask"] = np.zeros(reg.block_shape("mask"), np.int32)


def refined_forest(cells=(4, 4, 4), depth=2):
    """(forest, registry, arena): two roots, one refined ``depth`` times
    along its lowest-id block, zero-filled, adopted by a level arena."""
    reg = make_lbm_fields(LBMBlockSpec(cells=cells))
    forest = make_uniform_forest(ForestGeometry(root_grid=(2, 1, 1), max_level=6), 1, level=0)
    _seed(forest, reg)
    pipe = AMRPipeline(balancer=SFCBalancer(), registry=reg)
    for level in range(depth):
        pick = min(b.bid for b in forest.all_blocks() if b.level == level)
        forest, _ = pipe.run_cycle(forest, Comm(1), lambda r, blocks, pick=pick, to=level + 1: {pick: to})
        _seed(forest, reg)
    arena = LevelArena(reg)
    arena.adopt(forest)
    return forest, reg, arena
