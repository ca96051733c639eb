"""Typed block-field API: one declaration drives the whole framework.

The paper's blocks "support the storage of arbitrary data" via user-registered
serialization callbacks (§2.5). The raw mechanism — six callbacks per item
(:class:`~repro.core.migration.BlockDataItem`) — is maximally general but
forces every physics module to hand-write the same volumetric split/merge
boilerplate, and gives the framework no type information to build fast data
paths from. This module layers a *typed* field API on top:

* :class:`FieldSpec` — one declaration per physics field: name, dtype,
  per-cell component shape, ghost width, and a declarative refine/coarsen
  policy (``copy | inject | interpolate`` x ``copy | restrict | max`` or
  custom functions);
* :class:`FieldRegistry` — a :class:`BlockDataRegistry` subclass that
  **derives** the six migration callbacks, checkpoint encode/decode, and
  resilience snapshot/restore from the declarations. Untyped
  ``BlockDataRegistry`` (e.g. :meth:`BlockDataRegistry.trivial`) keeps
  working everywhere as the compatibility shim for meshless/opaque data;
* :class:`LevelArena` — persistent per-level struct-of-arrays storage: one
  contiguous ``(B, *field_shape)`` buffer per (level, field) with a
  bid -> slot index maintained across migration/refine/coarsen. Every
  ``Block.data[name]`` entry is a zero-copy view into its arena buffer, so
  ghost exchange and diagnostics keep their per-block interface while the
  stepping loop hands whole buffers to the kernels — no per-substep
  restacking.

Registering a new physics field is one line::

    reg = FieldRegistry(cells=(16, 16, 16))
    reg.add(FieldSpec("temperature", dtype=np.float32,
                      refine="interpolate", coarsen="restrict"))

and migration, checkpoint/restart, buddy resilience, halo exchange, and the
arena data plane all pick it up with no further code.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..telemetry import get_tracer
from .forest import Block, BlockForest
from .migration import BlockDataItem, BlockDataRegistry

_TR = get_tracer()

__all__ = [
    "FieldSpec",
    "FieldRegistry",
    "LevelArena",
    "RankArenas",
    "DeviceResidency",
    "octant_slices",
    "coarsen2",
    "refine2",
]


# -- volumetric resampling primitives (paper §3.3, [54]/[16]) -----------------


def _interior_slice(g: int) -> slice:
    return slice(g, -g) if g else slice(None)  # slice(0, -0) would be empty


def octant_slices(o: int, n: tuple[int, int, int], g: int) -> tuple[slice, slice, slice]:
    """Interior slices of octant ``o`` of a ghosted (nx+2g, ny+2g, nz+2g) array."""
    ox, oy, oz = o & 1, (o >> 1) & 1, (o >> 2) & 1
    nx, ny, nz = n
    return (
        slice(g + ox * nx // 2, g + (ox + 1) * nx // 2),
        slice(g + oy * ny // 2, g + (oy + 1) * ny // 2),
        slice(g + oz * nz // 2, g + (oz + 1) * nz // 2),
    )


def _group2(a: np.ndarray) -> np.ndarray:
    """View the last three axes as 2x2x2 groups: (..., x/2, 2, y/2, 2, z/2, 2)."""
    s = a.shape
    return a.reshape(*s[:-3], s[-3] // 2, 2, s[-2] // 2, 2, s[-1] // 2, 2)


def coarsen2(a: np.ndarray) -> np.ndarray:
    """Average 2x2x2 groups over the last three axes (volumetric restrict)."""
    return _group2(a).mean(axis=(-5, -3, -1))


def refine2(a: np.ndarray) -> np.ndarray:
    """Replicate each cell into 2x2x2 over the last three axes (volumetric split)."""
    for ax in (-3, -2, -1):
        a = np.repeat(a, 2, axis=ax)
    return a


def _coarsen_max(a: np.ndarray) -> np.ndarray:
    """2x2x2 max over the last three axes (categorical merge: 'prefer walls')."""
    return _group2(a).max(axis=(-5, -3, -1))


_REFINE_FNS: dict[str, Callable[[np.ndarray], np.ndarray]] = {
    # both replicate cell values onto the 2x finer grid; they differ in intent
    # (and are allowed to diverge, e.g. to trilinear interpolation):
    "interpolate": refine2,  # continuous data; conservative w.r.t. cell averages
    "inject": refine2,  # categorical data (piecewise-constant injection)
}
_COARSEN_FNS: dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "restrict": coarsen2,  # mean over the 2x2x2 octet (mass-conservative)
    "max": _coarsen_max,  # categorical reduce
}


@dataclass(frozen=True)
class FieldSpec:
    """Declaration of one typed per-block mesh field.

    The stored array has shape ``(*shape, nx+2g, ny+2g, nz+2g)``: ``shape``
    leading per-cell component axes (e.g. ``(Q,)`` for PDFs, ``()`` for a
    scalar), then the three ghosted spatial axes.

    ``refine`` governs the split data path (coarse parent -> 8 fine children)
    and ``coarsen`` the merge path (8 fine children -> coarse parent):

    * ``refine="interpolate" | "inject"`` — the *unmodified* coarse octant is
      serialized on the sender; the prolongation onto the finer grid happens
      on the receiver during deserialization (the paper's §2.5/§3.3 memory
      argument: no 8x reserve on the source). A custom callable maps the
      coarse octant interior to the full fine interior.
    * ``coarsen="restrict" | "max"`` — restriction happens on the *sender*
      before serialization; the receiver only assembles the eight coarse
      octant payloads. A custom callable maps the fine interior to one
      coarse octant payload.
    * ``refine="copy"`` / ``coarsen="copy"`` — opaque pass-through: every
      child receives the full parent array; a merged parent takes octant 0's
      array (for per-block metadata that has no mesh semantics).
    """

    name: str
    dtype: Any = np.float32
    shape: tuple[int, ...] = ()
    ghost: int = 1
    refine: str | Callable[[np.ndarray], np.ndarray] = "interpolate"
    coarsen: str | Callable[[np.ndarray], np.ndarray] = "restrict"

    def block_shape(self, cells: tuple[int, int, int]) -> tuple[int, ...]:
        g2 = 2 * self.ghost
        return (*self.shape, cells[0] + g2, cells[1] + g2, cells[2] + g2)

    def _refine_fn(self) -> Callable[[np.ndarray], np.ndarray] | None:
        if self.refine == "copy":
            return None
        if callable(self.refine):
            return self.refine
        return _REFINE_FNS[self.refine]

    def _coarsen_fn(self) -> Callable[[np.ndarray], np.ndarray] | None:
        if self.coarsen == "copy":
            return None
        if callable(self.coarsen):
            return self.coarsen
        return _COARSEN_FNS[self.coarsen]


def _derive_item(spec: FieldSpec, cells: tuple[int, int, int]) -> BlockDataItem:
    """Derive the six §2.5 serialization callbacks from one declaration."""
    g = spec.ghost
    full = spec.block_shape(cells)
    refine_fn = spec._refine_fn()
    coarsen_fn = spec._coarsen_fn()
    interior = (Ellipsis,) + (_interior_slice(g),) * 3

    def ser_move(d: Any, _blk: Block) -> Any:
        return d

    def des_move(p: Any, _blk: Block) -> Any:
        return p

    def ser_split(d: np.ndarray, _blk: Block, o: int) -> np.ndarray:
        if refine_fn is None:  # copy policy: full array to every child
            return d
        sx, sy, sz = octant_slices(o, cells, g)
        return np.ascontiguousarray(d[..., sx, sy, sz])  # unmodified coarse data

    def des_split(p: np.ndarray, _blk: Block) -> np.ndarray:
        if refine_fn is None:
            return np.array(p) if isinstance(p, np.ndarray) else p
        out = np.zeros(full, dtype=spec.dtype)
        out[interior] = refine_fn(p)  # prolong on the receiver (§3.3)
        return out

    def ser_merge(d: np.ndarray, _blk: Block) -> np.ndarray:
        if coarsen_fn is None:
            return d
        return coarsen_fn(d[interior]).astype(spec.dtype)  # restrict on the sender

    def des_merge(parts: dict[int, np.ndarray], _blk: Block) -> np.ndarray:
        if coarsen_fn is None:
            p = parts[0]
            return np.array(p) if isinstance(p, np.ndarray) else p
        out = np.zeros(full, dtype=spec.dtype)
        for o, payload in parts.items():
            sx, sy, sz = octant_slices(o, cells, g)
            out[..., sx, sy, sz] = payload
        return out

    return BlockDataItem(
        serialize_move=ser_move,
        deserialize_move=des_move,
        serialize_split=ser_split,
        deserialize_split=des_split,
        serialize_merge=ser_merge,
        deserialize_merge=des_merge,
    )


class FieldRegistry(BlockDataRegistry):
    """Typed registry: :class:`FieldSpec` declarations with derived callbacks.

    A drop-in :class:`BlockDataRegistry` — migration, checkpoint, resilience,
    and the AMR pipeline consume it unchanged through ``items`` /
    ``encode_block`` / ``decode_block`` — plus the typed surface
    (``fields``, ``alloc``, ``block_shape``) that the arena data plane and
    halo exchange build on.
    """

    def __init__(
        self, cells: tuple[int, int, int], fields: Iterable[FieldSpec] = ()
    ) -> None:
        super().__init__()
        self.cells = tuple(int(c) for c in cells)
        for n in self.cells:
            assert n % 2 == 0, "cells per block must be even (octant split)"
        self.fields: dict[str, FieldSpec] = {}
        for spec in fields:
            self.add(spec)

    def add(self, spec: FieldSpec) -> FieldSpec:
        """Register one field; all framework callbacks are derived here."""
        assert spec.name not in self.fields, f"field {spec.name!r} already registered"
        self.fields[spec.name] = spec
        self.register(spec.name, _derive_item(spec, self.cells))
        return spec

    def block_shape(self, name: str) -> tuple[int, ...]:
        return self.fields[name].block_shape(self.cells)

    def alloc(self, name: str) -> np.ndarray:
        """A zeroed per-block array for field ``name`` (ghosted)."""
        spec = self.fields[name]
        return np.zeros(spec.block_shape(self.cells), dtype=spec.dtype)

    def interior(self, name: str, arr: np.ndarray) -> np.ndarray:
        s = _interior_slice(self.fields[name].ghost)
        return arr[..., s, s, s]

    # -- checkpoint / resilience hook (typed: validates on decode) -------------
    # encode_block's snapshot copy semantics come from the base registry.
    def decode_block(
        self, payload: dict[str, Any], blk: Block, *, copy: bool = False
    ) -> dict[str, Any]:
        data = super().decode_block(payload, blk, copy=copy)
        for name, spec in self.fields.items():
            arr = data.get(name)
            if arr is None:
                continue
            arr = np.asarray(arr)
            want = spec.block_shape(self.cells)
            if arr.shape != want:  # external input — must survive python -O
                raise ValueError(
                    f"field {name!r}: payload shape {arr.shape} != declared {want}"
                )
            data[name] = arr.astype(spec.dtype, copy=False)
        return data


class LevelArena:
    """Persistent per-level struct-of-arrays storage for all mesh fields.

    For every refinement level in use, the arena owns one contiguous
    ``(B, *field_shape)`` buffer per registered field, where ``B`` is the
    number of blocks on that level (across all simulated ranks — the data
    plane is host-side, like the stepping loop it feeds). ``Block.data[name]``
    is rebound to the block's zero-copy slice of the buffer, so all per-block
    code (ghost exchange, criteria, diagnostics, migration serializers) keeps
    working while kernels consume whole levels without restacking.

    :meth:`adopt` is the single maintenance point: call it after any forest
    topology change (AMR cycle, restart, resilience restore). It keeps the
    bid -> slot index consistent with the forest and reuses buffers when a
    level's block set is unchanged.

    With ``rank`` given, the arena is *rank-sharded*: it packs only blocks
    owned by that simulated rank, so its memory is O(local blocks) — the
    paper's per-rank bound — and a set of such arenas (:class:`RankArenas`)
    partitions the forest's data plane by owner.
    """

    def __init__(self, registry: FieldRegistry, rank: int | None = None) -> None:
        self.registry = registry
        self.rank = rank  # None: whole forest; int: only blocks owned by rank
        self._bufs: dict[int, dict[str, np.ndarray]] = {}  # level -> field -> SoA
        self._slots: dict[int, dict[int, int]] = {}  # level -> bid -> slot
        self.version = 0  # bumped on every adopt (cache invalidation hook)
        self._residency: "DeviceResidency | None" = None

    def _owned(self, forest: BlockForest) -> Iterable[Block]:
        if self.rank is None:
            return forest.all_blocks()
        return forest.local_blocks(self.rank).values()

    # -- data-plane access ------------------------------------------------------
    def levels(self) -> list[int]:
        return sorted(self._bufs)

    def buffer(self, level: int, name: str) -> np.ndarray | None:
        """The (B, *field_shape) SoA buffer for one level, or None."""
        return self._bufs.get(level, {}).get(name)

    def slots(self, level: int) -> dict[int, int]:
        """bid -> slot index for one level (slot order is ascending bid)."""
        return self._slots.get(level, {})

    def slot_of(self, level: int, bid: int) -> int:
        return self._slots[level][bid]

    def num_blocks(self, level: int) -> int:
        return len(self._slots.get(level, {}))

    # -- maintenance ------------------------------------------------------------
    def adopt(self, forest: BlockForest) -> None:
        """(Re)pack block fields into per-level buffers and rebind views.

        Blocks whose arrays already live in the right slot are left in place
        (no copy); freshly materialized arrays (from migration deserialize,
        checkpoint load, or block init) are copied into their slot once.
        """
        if self._residency is not None:
            # device-side results must be flushed before the storage they
            # mirror is repacked — otherwise computed steps would vanish
            self._residency.check_no_pending()
        by_level: dict[int, list[Block]] = {}
        for b in self._owned(forest):
            by_level.setdefault(b.level, []).append(b)
        new_bufs: dict[int, dict[str, np.ndarray]] = {}
        new_slots: dict[int, dict[int, int]] = {}
        for level, blocks in by_level.items():
            blocks.sort(key=lambda b: b.bid)
            slots = {b.bid: i for i, b in enumerate(blocks)}
            reuse = self._slots.get(level) == slots
            bufs = dict(self._bufs.get(level, {})) if reuse else {}
            for name, spec in self.registry.fields.items():
                shape = (len(blocks), *spec.block_shape(self.registry.cells))
                buf = bufs.get(name)
                if buf is None or buf.shape != shape:
                    buf = np.zeros(shape, dtype=spec.dtype)
                for i, b in enumerate(blocks):
                    src = b.data.get(name)
                    view = buf[i]
                    if src is not None and src.base is not buf:
                        view[...] = src
                    b.data[name] = view
                bufs[name] = buf
            new_bufs[level] = bufs
            new_slots[level] = slots
        self._bufs = new_bufs
        self._slots = new_slots
        self.version += 1

    # -- device residency -------------------------------------------------------
    def device(self, device: torch.device | str | None = None) -> "DeviceResidency":
        """The arena's device-residency layer (created on first use, on
        ``device``; later calls may omit it and must not name another).

        Fused stepping keeps whole level buffers resident on the accelerator
        as ``torch.Tensor``s; host views are only rematerialized (via
        :meth:`DeviceResidency.flush`) when migration, checkpointing, or
        diagnostics actually need them. All host<->device traffic is counted,
        so tests can assert the steady-state substep loop performs zero
        transfers.
        """
        if self._residency is None:
            if device is None:
                raise ValueError("the first device() call must name the device")
            self._residency = DeviceResidency(self, torch.device(device))
        elif device is not None and torch.device(device) != self._residency.device:
            raise ValueError(
                f"arena is resident on {self._residency.device}, not {device}"
            )
        return self._residency

    # -- invariants (tests / verification) --------------------------------------
    def check_consistent(self, forest: BlockForest) -> None:
        """Slot index and views agree with the (rank-local) forest topology."""
        by_level: dict[int, set[int]] = {}
        for b in self._owned(forest):
            by_level.setdefault(b.level, set()).add(b.bid)
        assert set(self._slots) == set(by_level), (
            f"arena levels {sorted(self._slots)} != forest levels {sorted(by_level)}"
        )
        for level, bids in by_level.items():
            slots = self._slots[level]
            assert set(slots) == bids, f"L{level}: slot index out of sync"
            assert sorted(slots.values()) == list(range(len(bids))), (
                f"L{level}: slots not a dense permutation"
            )
        for b in self._owned(forest):
            slot = self._slots[b.level][b.bid]
            for name in self.registry.fields:
                buf = self._bufs[b.level][name]
                view = b.data[name]
                assert view.base is buf and view.shape == buf.shape[1:], (
                    f"block {b.bid:#x} field {name!r} is not an arena view"
                )
                expect = buf[slot]
                assert (
                    view.__array_interface__["data"][0]
                    == expect.__array_interface__["data"][0]
                ), f"block {b.bid:#x} field {name!r} bound to the wrong slot"


class DeviceResidency:
    """Device-resident mirror of a :class:`LevelArena`, version-tracked both
    ways.

    Each (level, field) buffer can live in one of three states:

    * **host-only** — no device copy exists; :meth:`fetch` uploads one
      (counted as an h2d transfer);
    * **synced** — a device copy exists and matches the host buffer;
      :meth:`fetch` returns it with no transfer;
    * **device-newer** — :meth:`store` installed a device-side update (the
      output of a jitted step); the host view is stale until :meth:`flush`
      downloads it back into the arena buffer *in place*, so every
      ``Block.data`` view stays bound.

    Invalidation across topology changes is by mechanism: an arena
    ``adopt()`` bumps ``arena.version``, which drops all device state on the
    next access (the buffers it mirrored no longer exist), and refuses to run
    at all while device-newer results are un-flushed (see
    :meth:`check_no_pending`). Host-side writes *between* adoptions are a
    manual contract — numpy views cannot announce mutation — so code that
    edits host buffers while a synced device copy exists (e.g. the driver's
    mask refresh) must call :meth:`drop` for the touched field or the edit
    never reaches the device; :meth:`drop` asserts if it would discard a
    pending device-side update.
    """

    def __init__(self, arena: LevelArena, device: torch.device) -> None:
        self.arena = arena
        self.device = device
        self._dev: dict[tuple[int, str], Any] = {}  # (level, field) -> torch.Tensor
        self._dev_newer: set[tuple[int, str]] = set()
        self._arena_version = arena.version
        self.h2d_transfers = 0
        self.h2d_bytes = 0
        self.d2h_transfers = 0
        self.d2h_bytes = 0

    @property
    def transfers(self) -> int:
        """Total host<->device transfers performed (both directions)."""
        return self.h2d_transfers + self.d2h_transfers

    def _sync_version(self) -> None:
        if self._arena_version != self.arena.version:
            # storage was rebound under us: every device copy mirrors a buffer
            # that no longer backs the forest — drop them all (adopt already
            # asserted nothing device-newer was pending; backstop here for
            # version bumps that bypass adopt)
            self.check_no_pending()
            self._dev.clear()
            self._arena_version = self.arena.version

    def fetch(self, level: int, name: str):
        """The device-resident buffer for (level, field).

        Args:
            level: refinement level whose arena buffer to mirror.
            name: registered field name.

        Returns:
            The ``torch.Tensor`` mirror of ``arena.buffer(level, name)`` on
            ``self.device``. If no
            device copy exists (first access, or everything was dropped by a
            version bump) the host buffer is uploaded and the transfer
            counted; otherwise the cached array — possibly a device-newer
            one installed by :meth:`store` — is returned with no transfer.

        The arena version is synchronized first: if ``arena.version`` moved
        since the last access (an ``adopt`` happened), all device state is
        dropped before the lookup, so a fetch can never return a mirror of
        storage that no longer backs the forest.
        """
        self._sync_version()
        key = (level, name)
        arr = self._dev.get(key)
        if arr is None:
            assert key not in self._dev_newer, f"{key} was taken and its successor not stored"
            host = self.arena.buffer(level, name)
            assert host is not None, f"no arena buffer for L{level} {name!r}"
            # copy=True: on a CPU device the mirror must not alias the host
            # buffer, or host-side writes would reach it without a drop()
            arr = torch.from_numpy(host).to(self.device, copy=True)
            self._dev[key] = arr
            self.h2d_transfers += 1
            self.h2d_bytes += host.nbytes
            if _TR.enabled:
                _TR.instant(
                    "h2d", cat="residency", rank=self.arena.rank or 0,
                    level=level, field=name, bytes=host.nbytes,
                )
        return arr

    def store(self, level: int, name: str, value) -> None:
        """Install a device-side update; the host view becomes stale.

        Args:
            level: refinement level the update belongs to.
            name: registered field name.
            value: the new device tensor (typically a superstep's output);
                its shape must match the arena buffer exactly.

        The (level, field) pair is marked *device-newer*: subsequent
        :meth:`fetch` calls return ``value`` without transfers, host readers
        must :meth:`flush` first, and an arena ``adopt()`` while the mark is
        set fails loudly (:meth:`check_no_pending`) instead of silently
        discarding computed steps.
        """
        self._sync_version()
        key = (level, name)
        host = self.arena.buffer(level, name)
        assert host is not None and value.shape == host.shape, (
            f"store shape {getattr(value, 'shape', None)} != arena "
            f"{None if host is None else host.shape} for L{level} {name!r}"
        )
        self._dev[key] = value
        self._dev_newer.add(key)

    def take(self, level: int, name: str):
        """Hand the device buffer for (level, field) to a caller that
        consumes it, such as a superstep that frees each input once its
        successor exists.

        Returns :meth:`fetch`'s buffer and forgets it, leaving the pair
        marked device-newer: the caller must :meth:`store` its successor
        before the pair is fetched, flushed or adopted again.
        """
        arr = self.fetch(level, name)
        del self._dev[(level, name)]
        self._dev_newer.add((level, name))
        return arr

    def drop(self, name: str | None = None, level: int | None = None) -> None:
        """Forget device copies (after a host-side write made them stale).

        Args:
            name: restrict to one field (``None`` = every field).
            level: restrict to one level (``None`` = every level).

        Host-side writes between adoptions are a manual contract — numpy
        views cannot announce mutation — so code that edits host buffers
        while a synced device copy exists (e.g. the driver's mask refresh)
        must call this for the touched field, or the edit never reaches the
        device. Dropping a *device-newer* entry asserts: that would discard
        a computed result — ``flush()`` first.
        """
        self._sync_version()
        for key in [
            k
            for k in self._dev
            if (name is None or k[1] == name) and (level is None or k[0] == level)
        ]:
            assert key not in self._dev_newer, (
                f"host write raced a pending device update for {key}: flush() "
                "before mutating host buffers the device owns"
            )
            del self._dev[key]

    def check_no_pending(self) -> None:
        """Assert no un-flushed device-newer state exists (called by
        ``LevelArena.adopt`` so a missing flush fails loudly instead of
        silently discarding computed steps)."""
        assert not self._dev_newer, (
            f"device-newer state pending for {sorted(self._dev_newer)}: "
            "flush() before rebinding/adopting the arena"
        )

    def flush(self) -> None:
        """Materialize host views: download every device-newer buffer into
        its arena storage in place (block views stay bound).

        Downloads are counted (``d2h_transfers`` / ``d2h_bytes``) and the
        device-newer marks cleared; the device copies are kept and remain
        *synced*, so a later :meth:`fetch` performs no re-upload. Idempotent:
        a second flush with nothing pending transfers nothing — the
        conformance suite relies on this to pin "transfers only when state
        actually moved".
        """
        self._sync_version()
        for key in sorted(self._dev_newer):
            level, name = key
            host = self.arena.buffer(level, name)
            # in place into the numpy buffer: every Block.data view stays bound
            torch.from_numpy(host).copy_(self._dev[key])
            self.d2h_transfers += 1
            self.d2h_bytes += host.nbytes
            if _TR.enabled:
                _TR.instant(
                    "d2h", cat="residency", rank=self.arena.rank or 0,
                    level=level, field=name, bytes=host.nbytes,
                )
        self._dev_newer.clear()


class RankArenas:
    """The rank-sharded data plane: one :class:`LevelArena` per simulated rank.

    Each rank's arena holds only the blocks that rank owns, so every per-rank
    buffer is bounded by the local block count — stepping a rank touches no
    other rank's memory, which is what makes the sharded stepping mode an
    end-to-end distributed data plane (cross-rank ghost data must travel as
    messages, never as direct reads).

    :meth:`adopt` rebuilds every rank's arena from the forest's current
    ownership; it is the single maintenance point after migration, refine,
    coarsen, or restore (the sharded analogue of global restacking). The
    shared ``version`` counter invalidates downstream caches (device masks,
    halo exchange plans, compiled per-rank programs) exactly like
    :class:`LevelArena.version` does — callers pass it as the O(1)
    ``cache_token`` to the plan caches and key compiled-program caches on
    it, so no cache can survive a storage rebind.

    Device residency is per rank: ``per_rank[r].device()`` returns rank r's
    own :class:`DeviceResidency` (created on first use), which is what lets
    the ``fused_sharded`` stepping mode keep every rank's state resident on
    its (simulated) accelerator and count per-rank transfers independently.
    """

    def __init__(self, registry: FieldRegistry, nranks: int) -> None:
        self.registry = registry
        self.nranks = nranks
        self.per_rank = [LevelArena(registry, rank=r) for r in range(nranks)]
        self.version = 0

    def adopt(self, forest: BlockForest) -> None:
        """Rebuild every rank's arena from the forest's current ownership
        and bump the shared version counter.

        Args:
            forest: the post-cycle forest; its ``nranks`` must match.

        Each per-rank adopt refuses to run while that rank holds un-flushed
        device-newer state (see :meth:`DeviceResidency.check_no_pending`),
        so a missing ``materialize_host()`` before an AMR event fails loudly
        on the exact rank that would have lost steps."""
        assert forest.nranks == self.nranks, (forest.nranks, self.nranks)
        for arena in self.per_rank:
            arena.adopt(forest)
        self.version += 1

    def buffer(self, rank: int, level: int, name: str) -> np.ndarray | None:
        """Rank ``rank``'s (B_local, *field_shape) SoA buffer, or None."""
        return self.per_rank[rank].buffer(level, name)

    def num_blocks(self, rank: int, level: int) -> int:
        return self.per_rank[rank].num_blocks(level)

    def levels(self) -> list[int]:
        return sorted({l for a in self.per_rank for l in a.levels()})

    def held_bytes_per_rank(self) -> list[int]:
        """Data-plane bytes resident per rank (the Table-1 quantity for the
        data plane: must stay O(local blocks), independent of nranks)."""
        return [
            sum(buf.nbytes for fields in a._bufs.values() for buf in fields.values())
            for a in self.per_rank
        ]

    def check_consistent(self, forest: BlockForest) -> None:
        for arena in self.per_rank:
            arena.check_consistent(forest)
