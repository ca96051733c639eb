"""Carry a simulation's state across, as plain numpy.

This system has no weights: its state is the block forest (ids, levels,
owners) and each block's arrays. :func:`export_state` reads that state from
any driver exposing ``forest``, ``geom``, ``spec`` and ``materialize_host``
(this port's :class:`~.lbm.driver.AMRLBM`, or the JAX package's, whose
surface is the same); :func:`load_state` installs it into this port's driver,
so two implementations can take the same step from identical state.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

import numpy as np

from .core.forest import Block, BlockForest, build_adjacency

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .lbm.driver import AMRLBM

__all__ = ["export_state", "load_state"]

BlockState = tuple[int, int, dict[str, np.ndarray]]  # (level, owner, arrays)


def export_state(sim: Any) -> dict[str, Any]:
    """``{"root_grid", "cells_per_block", "ghost", "nranks", "blocks"}`` with
    ``blocks = {bid: (level, owner, {"pdf": ndarray, "mask": ndarray})}``;
    the arrays are copies."""
    sim.materialize_host()
    blocks = {
        b.bid: (b.level, b.owner, {k: np.array(b.data[k]) for k in ("pdf", "mask")})
        for b in sim.forest.all_blocks()
    }
    return {
        "root_grid": tuple(sim.geom.root_grid),
        "cells_per_block": tuple(sim.spec.cells),
        "ghost": sim.spec.ghost,
        "nranks": sim.forest.nranks,
        "blocks": blocks,
    }


def load_state(sim: "AMRLBM", state: dict[str, Any]) -> None:
    """Replace ``sim``'s forest and block data with ``state`` (as made by
    :func:`export_state`). The geometry must match ``sim``'s configuration;
    adjacency is rebuilt from the block ids, and the arrays are copied."""
    want = {
        "root_grid": tuple(sim.geom.root_grid),
        "cells_per_block": tuple(sim.spec.cells),
        "ghost": sim.spec.ghost,
        "nranks": sim.forest.nranks,
    }
    got = {k: state[k] for k in want}
    if got != want:
        raise ValueError(f"state geometry {got} does not match the simulation's {want}")
    shapes = {"pdf": sim.spec.pdf_shape, "mask": sim.spec.mask_shape}
    dtypes = {"pdf": np.float32, "mask": np.int32}
    blocks = []
    for bid, (level, owner, arrays) in state["blocks"].items():
        data = {}
        for name, shape in shapes.items():
            arr = np.asarray(arrays[name])
            if arr.shape != tuple(shape):
                raise ValueError(f"block {bid:#x} {name}: shape {arr.shape} != {tuple(shape)}")
            data[name] = arr.astype(dtypes[name], copy=True)
        blocks.append(Block(bid=int(bid), level=int(level), owner=int(owner), data=data))
    build_adjacency(sim.geom, blocks)
    forest = BlockForest(sim.geom, sim.forest.nranks)
    for b in blocks:
        forest.insert(b)
    sim.materialize_host()  # nothing device-newer may be pending at adopt
    sim.forest = forest
    sim.engine.adopt(forest)
    sim.engine.sync_caches()
    sim.engine.masks_refreshed()
