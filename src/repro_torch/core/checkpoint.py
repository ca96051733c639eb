"""Checkpoint/restart built on the migration serializers (paper §4.1).

A checkpoint is (a) the *topology file* — the current distributed block
partitioning (IDs, levels, owners, weights, adjacency) — plus (b) one payload
file per rank containing the move-serialized block data. On a real machine
(b) is written with parallel MPI I/O / per-host files; here each simulated
rank writes its own file, which preserves the structure exactly.

Restart may use a *different* rank count: the topology is reloaded, blocks
are redistributed along the Morton curve (the standard initial partition),
and the payloads are deserialized on their new owners — "loading the
previously created snapshot" followed by the data structure initialization
of [57]. A subsequent AMR cycle rebalances if required.

The two halves of that protocol are exposed separately as
:func:`snapshot_payloads` (registry-codec encode of every block) and
:func:`rebuild_forest` (Morton redistribution + decode onto the new owners),
so in-memory consumers — the elastic rank-resize in
:mod:`repro.serving.elastic` — can run the identical snapshot/restore path
without touching disk.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Any

from .blockid import ForestGeometry
from .forest import Block, BlockForest, build_adjacency
from .migration import BlockDataRegistry

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "snapshot_payloads",
    "rebuild_forest",
]


def snapshot_payloads(
    forest: BlockForest, registry: BlockDataRegistry, *, copy: bool = False
) -> dict[int, dict[str, Any]]:
    """Move-serialize every block's data through the registry codec.

    Returns bid -> payload for the whole forest — the in-memory equivalent of
    the per-rank checkpoint payload files. With ``copy=False`` payloads alias
    the live arrays (safe when immediately persisted or decoded, as both the
    on-disk checkpoint and the elastic resize do); pass ``copy=True`` to keep
    a snapshot that survives later in-place mutation.
    """
    return {
        bid: registry.encode_block(blk, copy=copy)
        for r in range(forest.nranks)
        for bid, blk in forest.local_blocks(r).items()
    }


def rebuild_forest(
    geom: ForestGeometry,
    entries: list[dict],
    payloads: dict[int, dict[str, Any]],
    registry: BlockDataRegistry,
    nranks: int,
) -> BlockForest:
    """Reassemble a forest from topology entries + codec payloads onto
    ``nranks`` ranks: blocks are redistributed in equal contiguous chunks
    along the Morton curve (the standard initial partition) and each payload
    is deserialized on its new owner. ``entries`` holds one
    ``{"bid", "level", "weight"}`` dict per block (the topology-file rows;
    any previous ``owner`` is irrelevant — ownership is recomputed)."""
    entries = sorted(entries, key=lambda e: geom.morton_key(e["bid"]))
    forest = BlockForest(geom, nranks)
    blocks = []
    n = len(entries)
    for i, e in enumerate(entries):
        owner = min(nranks - 1, i * nranks // max(1, n))
        blk = Block(bid=e["bid"], level=e["level"], owner=owner, weight=e["weight"])
        blk.data = registry.decode_block(payloads[e["bid"]], blk)
        blocks.append(blk)
    build_adjacency(geom, blocks)
    for b in blocks:
        forest.insert(b)
    return forest


def save_checkpoint(
    forest: BlockForest, registry: BlockDataRegistry, path: str | Path
) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    topo = {
        "geom": {"root_grid": list(forest.geom.root_grid), "max_level": forest.geom.max_level},
        "nranks": forest.nranks,
        "blocks": [
            {"bid": b.bid, "level": b.level, "owner": b.owner, "weight": b.weight}
            for b in forest.all_blocks()
        ],
    }
    (path / "topology.json").write_text(json.dumps(topo))
    for r in range(forest.nranks):
        payload = {
            # no owned copies needed: pickle.dump snapshots the arrays itself
            bid: registry.encode_block(blk, copy=False)
            for bid, blk in forest.local_blocks(r).items()
        }
        with open(path / f"rank_{r:06d}.pkl", "wb") as f:
            pickle.dump(payload, f)


def load_checkpoint(
    path: str | Path,
    registry: BlockDataRegistry,
    nranks: int | None = None,
) -> BlockForest:
    """Restore a forest, optionally onto a different number of ranks."""
    path = Path(path)
    topo = json.loads((path / "topology.json").read_text())
    geom = ForestGeometry(
        root_grid=tuple(topo["geom"]["root_grid"]), max_level=topo["geom"]["max_level"]
    )
    old_nranks = topo["nranks"]
    nranks = nranks or old_nranks
    # gather payloads (indexed by bid — rank layout on disk is irrelevant)
    payloads: dict[int, dict] = {}
    for r in range(old_nranks):
        with open(path / f"rank_{r:06d}.pkl", "rb") as f:
            payloads.update(pickle.load(f))
    return rebuild_forest(geom, topo["blocks"], payloads, registry, nranks)
