"""Data migration, refinement, and coarsening in one step (paper §2.5).

The framework never interprets block data. Each block-data item is registered
with **six callbacks** (three serialize/deserialize pairs): move, split, and
merge. During migration the framework invokes the right pair per block:

* **move**  — serialize on the source, deserialize on the target, unmodified;
* **split** — the source serializes one payload per octant *without*
  refining; interpolation to the fine grid happens on the *target* during
  deserialization (so no 8x memory reserve is ever needed on the source —
  the paper's memory argument in §2.5);
* **merge** — the source *coarsens before serializing*; the target only
  assembles the eight coarse octant payloads.

Refinement and coarsening always go through serialize/deserialize, even when
source and target rank coincide (paper §2.5), which keeps the code paths
identical and extensible to arbitrary data.
"""

from __future__ import annotations

import copy as _copy
import pickle
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from .blockid import child_id, children_ids, octant_of, parent_id
from .comm import BYTES_BLOCK_ID, Comm
from .forest import Block, BlockForest

__all__ = ["BlockDataItem", "BlockDataRegistry", "migrate_data"]


def payload_nbytes(obj: Any) -> int:
    """Exact serialized size of a payload in the fabric's byte accounting.

    Containers are sized recursively — including *ragged* structures such as
    dict-of-ndarray particle sets, where every array has its own length — and
    dict keys are counted (a real wire format ships them). Numpy scalars are
    their itemsize, python scalars the fixed-width convention below. Only
    genuinely opaque objects fall back to their pickled size; nothing falls
    through to a flat guess, so migration byte counts for arbitrary §2.5
    payloads (the Table-1 quantities) are exact."""
    if obj is None:
        return 0
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, np.generic):  # numpy scalar: its in-memory width
        return obj.dtype.itemsize
    if isinstance(obj, bool):
        return 1
    if isinstance(obj, (int, float, complex)):
        return 16 if isinstance(obj, complex) else 8
    if isinstance(obj, str):
        return len(obj.encode())
    if isinstance(obj, (bytes, bytearray)):
        return len(obj)
    if isinstance(obj, (list, tuple, set, frozenset)):
        return sum(payload_nbytes(o) for o in obj)
    if isinstance(obj, dict):
        return sum(payload_nbytes(k) + payload_nbytes(v) for k, v in obj.items())
    try:
        return len(pickle.dumps(obj))
    except Exception:
        return 64


def _snapshot_copy(v: Any) -> Any:
    """Owned copy of a payload value: arrays directly, containers recursively
    (the §2.5 contract allows arbitrary nested data)."""
    if isinstance(v, np.ndarray):
        return np.array(v)
    if isinstance(v, (dict, list, tuple)):
        return _copy.deepcopy(v)
    return v  # scalars/str/bytes are immutable; opaque objects stay opaque


@dataclass
class BlockDataItem:
    """The six serialization callbacks for one named block-data item."""

    serialize_move: Callable[[Any, Block], Any]
    deserialize_move: Callable[[Any, Block], Any]
    # split: (data, old block, octant) -> payload; payload -> child data
    serialize_split: Callable[[Any, Block, int], Any]
    deserialize_split: Callable[[Any, Block], Any]
    # merge: (data, old block) -> coarsened octant payload;
    #        ({octant: payload}, new block) -> merged data
    serialize_merge: Callable[[Any, Block], Any]
    deserialize_merge: Callable[[dict[int, Any], Block], Any]


class BlockDataRegistry:
    def __init__(self) -> None:
        self.items: dict[str, BlockDataItem] = {}

    def register(self, name: str, item: BlockDataItem) -> None:
        self.items[name] = item

    # -- whole-block snapshot codec (checkpoint §4.1, resilience §4.2) ---------
    # Both subsystems need exactly move semantics: serialize on the owner,
    # deserialize wherever the block lands. Deriving them here keeps every
    # registry — including the typed FieldRegistry, which overrides
    # decode_block with shape/dtype validation — the single source of truth.
    #
    # Move callbacks commonly pass arrays by reference (right for migration,
    # where the source forest is discarded). A long-lived in-memory snapshot
    # must instead own its arrays — in-place stepping would silently mutate
    # it — so ``copy=True`` copies every ndarray payload. Payloads that are
    # immediately serialized (disk checkpoint) skip the copy.
    def encode_block(self, blk: Block, *, copy: bool = True) -> dict[str, Any]:
        payload = {
            name: item.serialize_move(blk.data.get(name), blk)
            for name, item in self.items.items()
        }
        if copy:
            payload = {n: _snapshot_copy(v) for n, v in payload.items()}
        return payload

    def decode_block(
        self, payload: dict[str, Any], blk: Block, *, copy: bool = False
    ) -> dict[str, Any]:
        data = {
            name: item.deserialize_move(payload.get(name), blk)
            for name, item in self.items.items()
        }
        if copy:  # restore paths: the snapshot must survive the restored run
            data = {n: _snapshot_copy(v) for n, v in data.items()}
        return data

    @staticmethod
    def trivial(name: str = "payload") -> "BlockDataRegistry":
        """Registry for opaque payloads (no refinement semantics) — useful
        for meshless data and tests."""
        reg = BlockDataRegistry()
        ident2 = lambda d, b: d
        reg.register(
            name,
            BlockDataItem(
                serialize_move=ident2,
                deserialize_move=ident2,
                serialize_split=lambda d, b, o: d,
                deserialize_split=ident2,
                serialize_merge=ident2,
                deserialize_merge=lambda parts, b: parts,
            ),
        )
        return reg


def migrate_data(
    actual: BlockForest,
    proxy: BlockForest,
    comm: Comm,
    registry: BlockDataRegistry,
) -> BlockForest:
    """Adapt the actual forest to the balanced proxy: refine, coarsen, and
    migrate all simulation data in one single step (paper §2.5, Fig. 6).

    Returns the new actual forest (topology copied from the proxy, data
    produced by the registered callbacks). The proxy is left untouched and
    is destroyed by the caller (pipeline)."""
    R = actual.nranks
    geom = actual.geom
    new_forest = BlockForest(geom, R)

    # new topology from the proxy (adjacency & weights are authoritative there)
    for r in range(R):
        for pb in proxy.local_blocks(r).values():
            nb = Block(
                bid=pb.bid,
                level=pb.level,
                owner=r,
                neighbors=dict(pb.neighbors),
                weight=pb.weight,
            )
            new_forest.insert(nb)

    # serialize + route payloads according to the bilateral links
    # message payloads: (new_bid, kind, octant, {item: payload})
    local_deliveries: list[list[tuple[int, str, int, dict[str, Any]]]] = [
        [] for _ in range(R)
    ]
    for r in range(R):
        for bid, blk in actual.local_blocks(r).items():
            t = blk.target_level
            if t == blk.level:
                tgt = blk.target_ranks[0]
                if tgt == r:
                    # plain keep: rebind data locally, no serialization
                    new_forest.local_blocks(r)[bid].data = blk.data
                    continue
                payloads = {
                    n: it.serialize_move(blk.data.get(n), blk)
                    for n, it in registry.items.items()
                }
                comm.send(r, tgt, "mig", (bid, "move", 0, payloads),
                          nbytes=BYTES_BLOCK_ID + payload_nbytes(payloads))
            elif t == blk.level + 1:
                for o in range(8):
                    tgt = blk.target_ranks[o]
                    payloads = {
                        n: it.serialize_split(blk.data.get(n), blk, o)
                        for n, it in registry.items.items()
                    }
                    msg = (child_id(bid, o), "split", o, payloads)
                    if tgt == r:
                        local_deliveries[r].append(msg)
                    else:
                        comm.send(r, tgt, "mig", msg,
                                  nbytes=BYTES_BLOCK_ID + payload_nbytes(payloads))
            else:  # merge: coarsen on the sender, assemble on the target
                tgt = blk.target_ranks[0]
                payloads = {
                    n: it.serialize_merge(blk.data.get(n), blk)
                    for n, it in registry.items.items()
                }
                msg = (parent_id(bid), "merge", octant_of(bid), payloads)
                if tgt == r:
                    local_deliveries[r].append(msg)
                else:
                    comm.send(r, tgt, "mig", msg,
                              nbytes=BYTES_BLOCK_ID + 1 + payload_nbytes(payloads))

    inbox = comm.exchange()
    arrivals: list[list[tuple[int, str, int, dict[str, Any]]]] = [[] for _ in range(R)]
    for dst, msgs in inbox.items():
        for _tag, msg in msgs:
            arrivals[dst].append(msg)
    for r in range(R):
        arrivals[r].extend(local_deliveries[r])

    merge_parts: list[dict[int, dict[int, dict[str, Any]]]] = [dict() for _ in range(R)]
    for r in range(R):
        blocks = new_forest.local_blocks(r)
        for new_bid, kind, octant, payloads in arrivals[r]:
            assert new_bid in blocks, (
                f"rank {r} received data for {new_bid:#x} it does not own"
            )
            nb = blocks[new_bid]
            if kind == "move":
                nb.data = {
                    n: registry.items[n].deserialize_move(p, nb)
                    for n, p in payloads.items()
                }
            elif kind == "split":
                nb.data = {
                    n: registry.items[n].deserialize_split(p, nb)
                    for n, p in payloads.items()
                }
            else:  # merge: collect all 8 octants, then assemble
                merge_parts[r].setdefault(new_bid, {})[octant] = payloads
    for r in range(R):
        blocks = new_forest.local_blocks(r)
        for new_bid, parts in merge_parts[r].items():
            assert len(parts) == 8, f"merge {new_bid:#x}: got {sorted(parts)} octants"
            nb = blocks[new_bid]
            nb.data = {
                n: registry.items[n].deserialize_merge(
                    {o: p[n] for o, p in parts.items()}, nb
                )
                for n in registry.items
            }
    return new_forest
