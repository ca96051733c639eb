"""Stepping engines: one class per ``stepping_mode``, one shared contract.

:class:`~.driver.AMRLBM` owns the control plane (forest, AMR pipeline,
criterion, ``Comm``, diagnostics); a :class:`StepEngine` owns the data plane
for one stepping mode — storage (none / ``LevelArena``), the kernel
steppers, cached exchange plans, device masks and the per-coarse-step
function, and the per-mode advance loop.

Engine surface:

* :meth:`StepEngine.advance` — run whole coarse steps (substep cycle
  included); attributes wall time to ``sim.data_stats``.
* :meth:`StepEngine.exchange_ghosts` — host-visible ghost refresh, used by
  the advance loop of the host modes and after AMR events.
* :meth:`StepEngine.adopt` — rebind storage after a forest topology change.
* :meth:`StepEngine.sync_caches` / :meth:`StepEngine.masks_refreshed` —
  invalidation by mechanism: caches are keyed to the storage version (every
  ``adopt`` bumps it), so no call site can replay a stale plan or mask.
* :meth:`StepEngine.materialize_host` — flush device-newer state so every
  ``Block.data`` view is current (no-op for host-resident modes).
* :meth:`StepEngine.particle_batches` — the advection batch source for the
  Lagrangian tracer layer (host modes batch a level, the sharded engines
  batch per rank so a rank's tracers read only the rank's own memory).

Modes of this port: ``restack`` (re-stack every substep, the conformance
oracle), ``arena`` (persistent per-level host buffers, uploaded and copied
back each substep), ``fused`` (the whole coarse step on the device over a
:class:`~..core.fields.DeviceResidency`, no host transfer between AMR
events), ``sharded`` (per-rank host arenas, cross-rank ghost data as p2p
messages through ``Comm``) and ``fused_sharded`` (per-rank device
residency: each rank emits its halo messages on the device, the host routes
them through ``Comm``, and each rank steps with its local and message rows
read in the stencil's halo route, with no host transfer between AMR
events) and ``device_sharded``
(one device per rank: each rank's padded block stacks live on its own
device, and every halo payload moves device to device with no host routing
per substep; the control plane stays on the host).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from ..core import LevelArena, RankArenas
from ..core.pipeline import StageStats
from ..device import resolve_device, synchronize
from ..kernels.lbm_collide.ops import (
    boundary_slot_sets,
    make_arena_stream_collide,
    make_device_superstep,
    make_fused_superstep,
    make_halo_stream_collide,
    make_rank_absorb,
    make_rank_absorb_split,
    make_rank_emit,
    make_stream_collide,
    run_compiled_ghost_plan,
    shared_halo_steps,
    substep_patterns,
)
from ..telemetry import get_tracer
from .grid import CellType
from .halo import (
    fill_ghost_layers,
    fill_ghost_layers_sharded,
    padded_block_counts,
    schedule_ppermute_rounds,
    verify_padded_plan,
)
from .lattice import omega_for_level
from .plans import (
    compile_forest_plan,
    compile_rank_forest_plan,
    pattern_plans,
    rank_pattern_plans,
    run_rank_plan_on_host,
)

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..core.forest import Block, BlockForest
    from .driver import AMRLBM

__all__ = ["StepEngine", "ENGINES", "make_engine", "resolve_rank_devices"]

ENGINES: dict[str, type["StepEngine"]] = {}

_TR = get_tracer()


def make_engine(sim: "AMRLBM") -> "StepEngine":
    mode = sim.cfg.stepping_mode
    if mode not in ENGINES:
        raise ValueError(f"unknown stepping_mode {mode!r}; expected one of {sorted(ENGINES)}")
    return ENGINES[mode](sim)


def _register(cls: type["StepEngine"]) -> type["StepEngine"]:
    ENGINES[cls.mode] = cls
    return cls


class StepEngine:
    """Shared state and hooks; subclasses fill in storage + the step loop."""

    mode: str = ""

    def __init__(self, sim: "AMRLBM") -> None:
        self.sim = sim
        self.cfg = sim.cfg
        # resolved once, here: None -> "cuda", raising when there is no card
        self.device = resolve_device(sim.cfg.device)
        self.arena: LevelArena | None = None
        self.arenas: RankArenas | None = None
        self._steppers: dict[int, Callable] = {}
        self._fused_steppers: dict[int, Callable] = {}
        # device mask cache; keys: level (arena) or (level, ranks) (sharded)
        self._mask_dev: dict = {}
        # ghost-exchange plans keyed by active level set; valid between arena
        # adoptions (restack rebinds arrays per substep, so no caching there)
        self._halo_plans: dict | None = {}
        self._cache_version = -1  # last storage version the caches were built for

    # -- kernel steppers -------------------------------------------------------
    stepper_factory = staticmethod(make_arena_stream_collide)

    def _stepper_kwargs(self, level: int) -> dict:
        cfg = self.cfg
        return dict(
            omega=omega_for_level(cfg.omega, level),
            lattice=self.sim.spec.lattice,
            u_wall=cfg.u_lid,
            collision=cfg.collision,
            backend=cfg.kernel_backend,
        )

    def _halo_stepper_factory(self, masks: dict, device: torch.device | None = None):
        """``(level, fill, level_index, messages=()) -> HaloStep`` builder
        for the halo-in-tile supersteps and rank absorbs; ``masks`` are host
        mask stacks (copied — the factory's constants must not alias
        mutable arena storage) or a rank's device mask stacks on ``device``
        (default: the engine's)."""
        device = self.device if device is None else device

        def factory(level: int, fill, level_index: dict[int, int], messages=()):
            return make_halo_stream_collide(
                fill,
                level_index,
                messages=messages,
                mask=masks[level],
                device=device,
                **self._stepper_kwargs(level),
            )

        return factory

    def _stepper(self, level: int) -> Callable:
        if level not in self._steppers:
            self._steppers[level] = self.stepper_factory(**self._stepper_kwargs(level))
        return self._steppers[level]

    def _fused_stepper(self, level: int) -> Callable:
        """Pure ``step(f, mask) -> f`` for the device-resident superstep
        (cached separately from the in-place arena steppers)."""
        if level not in self._fused_steppers:
            self._fused_steppers[level] = make_stream_collide(**self._stepper_kwargs(level))
        return self._fused_steppers[level]

    # -- storage / invalidation ------------------------------------------------
    def storage_version(self) -> int:
        if self.arena is not None:
            return self.arena.version
        if self.arenas is not None:
            return self.arenas.version
        return -1

    def adopt(self, forest: "BlockForest") -> None:
        """Rebind storage after a topology change (AMR event, restore)."""
        if self.arena is not None:
            self.arena.adopt(forest)
        if self.arenas is not None:
            self.arenas.adopt(forest)

    def sync_caches(self) -> None:
        """Drop device masks and ghost plans if the arena rebound storage
        since they were built — invalidation by mechanism, not by call-site
        discipline."""
        version = self.storage_version()
        if self._halo_plans is not None and self._cache_version != version:
            self._mask_dev.clear()
            self._halo_plans.clear()
            self._cache_version = version

    def masks_refreshed(self) -> None:
        """Host-side mask write happened: device mask copies are stale."""
        self._mask_dev.clear()

    def materialize_host(self) -> None:
        """Flush device-newer buffers so ``Block.data`` views are current
        (no-op in the host-resident modes)."""

    def residencies(self) -> list:
        """The engine's :class:`~..core.fields.DeviceResidency` objects
        (none in the host-resident modes), for transfer accounting."""
        return []

    # -- ghost exchange --------------------------------------------------------
    def exchange_ghosts(self, active: set[int] | None = None) -> None:
        """Refresh pdf ghost layers for the active levels on the host,
        attributing the wall time to the "halo" data-plane stage."""
        self.sync_caches()  # an external adopt() must not replay stale plans
        token = self.storage_version() if self._halo_plans is not None else None
        with _TR.stage("halo", cat="stage") as sp:
            fill_ghost_layers(
                self.sim.forest,
                self.sim.fields,
                fields=("pdf",),
                levels=active,
                plan_cache=self._halo_plans,
                cache_token=token,
            )
        self.sim.data_stats["halo"].add(StageStats(seconds=sp.seconds))

    # -- stepping --------------------------------------------------------------
    def advance(self, coarse_steps: int) -> None:
        """Host substep loop: per-level activity sets, ghost exchange, then
        stream+collide finest-first (the fused engine overrides wholesale)."""
        sim = self.sim
        levels = sim.forest.levels_in_use()
        lmax = max(levels)
        for _ in range(coarse_steps):
            for s in range(2**lmax):
                active = {l for l in levels if s % (2 ** (lmax - l)) == 0}
                self.exchange_ghosts(active)
                with _TR.stage("step", cat="stage") as sp:
                    for l in sorted(active, reverse=True):
                        self.step_level(l)
                sim.data_stats["step"].add(StageStats(seconds=sp.seconds))

    def step_level(self, level: int) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    # -- Lagrangian tracers ----------------------------------------------------
    def particle_batches(
        self, level: int
    ) -> list[tuple[np.ndarray, np.ndarray, dict[int, int], list["Block"]]]:
        """(pdf stack, mask stack, bid->slot, blocks) advection groups for one
        level (host views must be current — the driver materializes first)."""
        arena = self.arena
        pdf = arena.buffer(level, "pdf")
        if pdf is None or pdf.shape[0] == 0:
            return []
        blocks = [b for b in self.sim.forest.all_blocks() if b.level == level]
        return [(pdf, arena.buffer(level, "mask"), arena.slots(level), blocks)]


@_register
class RestackEngine(StepEngine):
    """Stack every block of a level into a fresh tensor each substep and copy
    the results back out — the conformance oracle."""

    mode = "restack"
    stepper_factory = staticmethod(make_stream_collide)

    def __init__(self, sim: "AMRLBM") -> None:
        super().__init__(sim)
        self._halo_plans = None  # arrays rebind every substep: nothing to cache

    def step_level(self, level: int) -> None:
        blocks = [b for b in self.sim.forest.all_blocks() if b.level == level]
        if not blocks:
            return
        f = torch.from_numpy(np.stack([b.data["pdf"] for b in blocks])).to(self.device)
        m = torch.from_numpy(np.stack([b.data["mask"] for b in blocks])).to(self.device)
        # repro: host-ok(restack-mode copy-out contract: results return to host block storage)
        out = self._stepper(level)(f, m).cpu().numpy()
        for i, b in enumerate(blocks):
            b.data["pdf"] = out[i]

    def particle_batches(self, level: int):
        blocks = sorted(
            (b for b in self.sim.forest.all_blocks() if b.level == level),
            key=lambda b: b.bid,
        )
        if not blocks:
            return []
        pdf = np.stack([b.data["pdf"] for b in blocks])
        mask = np.stack([b.data["mask"] for b in blocks])
        return [(pdf, mask, {b.bid: i for i, b in enumerate(blocks)}, blocks)]


@_register
class ArenaEngine(StepEngine):
    """Persistent per-level SoA host buffers, stepped in place: each substep
    uploads a level's buffer, steps it, and copies the result back."""

    mode = "arena"

    def __init__(self, sim: "AMRLBM") -> None:
        super().__init__(sim)
        self.arena = LevelArena(sim.fields)

    def _level_mask(self, level: int) -> torch.Tensor:
        """Device-resident (B, X, Y, Z) mask stack, cached across substeps."""
        self.sync_caches()
        m = self._mask_dev.get(level)
        if m is None:
            m = torch.from_numpy(self.arena.buffer(level, "mask")).to(self.device, copy=True)
            self._mask_dev[level] = m
        return m

    def step_level(self, level: int) -> None:
        buf = self.arena.buffer(level, "pdf")
        if buf is None or buf.shape[0] == 0:
            return
        # in place: reads and writes the persistent level buffer directly
        self._stepper(level)(buf, self._level_mask(level))


@_register
class FusedEngine(ArenaEngine):
    """Device-resident single-arena mode: the whole ``2^lmax`` substep cycle
    runs on the device over the arena's :class:`DeviceResidency`."""

    mode = "fused"

    def __init__(self, sim: "AMRLBM") -> None:
        super().__init__(sim)
        self.arena.device(self.device)
        # superstep cache: (arena version, level tuple) -> fn
        self._fused_fn = None
        self._fused_key: tuple | None = None
        # (slot map, ghost plan of each activity pattern) the superstep was
        # built from, for the protocol verifier
        self.held_plans: tuple | None = None
        # (arena version, the whole forest's compiled ghost plan): the host
        # fill after an AMR event and the next superstep's patterns share it
        self._forest_plan: tuple | None = None

    def _whole_plan(self):
        """The compiled pdf ghost plan of every level in use, cached until
        the arena's next adoption."""
        version = self.arena.version
        if self._forest_plan is None or self._forest_plan[0] != version:
            levels = sorted(self.sim.forest.levels_in_use())
            slots = {l: self.arena.slots(l) for l in levels}
            self._forest_plan = (version, compile_forest_plan(self.sim.forest, self.sim.fields, slots, levels))
        return self._forest_plan[1]

    def exchange_ghosts(self, active: set[int] | None = None) -> None:
        """The whole forest's host fill (after an AMR event, before
        tracers) through the compiled plan the next superstep's patterns
        are cut from, run in place on the arena's host stacks: bitwise the
        host plan's fill (``test_compiled_plan_matches_host_exchange_bitwise``)
        at one plan compile an event instead of two."""
        if active is not None:
            super().exchange_ghosts(active)
            return
        self.sync_caches()
        with _TR.stage("halo", cat="stage") as sp:
            run_compiled_ghost_plan(self._whole_plan(), {
                l: torch.from_numpy(self.arena.buffer(l, "pdf")) for l in self.sim.forest.levels_in_use()
            })
        self.sim.data_stats["halo"].add(StageStats(seconds=sp.seconds))

    def masks_refreshed(self) -> None:
        super().masks_refreshed()
        # host-side write: device mask copies (and the superstep that closed
        # over them) are stale
        self.arena.device().drop(name="mask")
        self._fused_fn = None
        self._fused_key = None

    def materialize_host(self) -> None:
        self.arena.device().flush()

    def residencies(self) -> list:
        return [self.arena.device()]

    def _fused_program(self) -> tuple[Callable, tuple[int, ...]]:
        """Get-or-build the superstep for the current forest: compiled ghost
        plans for every activity pattern + per-level steppers + device
        masks, cached until the next AMR event (arena version) or mask
        refresh."""
        forest = self.sim.forest
        levels = tuple(sorted(forest.levels_in_use()))
        key = (self.arena.version, levels)
        if self._fused_fn is not None and self._fused_key == key:
            return self._fused_fn, levels
        with _TR.span("build:fused_superstep", cat="compile", version=self.arena.version):
            slots = {l: self.arena.slots(l) for l in levels}
            plans = pattern_plans(self._whole_plan(), levels)
            res = self.arena.device()
            masks = {l: res.fetch(l, "mask") for l in levels}
            if self.cfg.kernel_backend == "ref":
                # repro: host-ok(host mask copy at program build, once per arena version)
                masks_halo = {l: np.array(self.arena.buffer(l, "mask")) for l in levels}
            else:  # the route reads the residency's masks: no second copy on the device
                masks_halo = masks
            self._fused_fn = make_fused_superstep(
                levels=levels,
                plans=plans,
                steppers={l: self._fused_stepper(l) for l in levels},
                masks=masks,
                halo_stepper_factory=self._halo_stepper_factory(masks_halo),
            )
            self.held_plans = (slots, plans)
        self._fused_key = key
        return self._fused_fn, levels

    def advance(self, coarse_steps: int) -> None:
        """Run whole coarse steps on the device, zero host transfers in
        steady state (uploads only after AMR events / mask refreshes;
        downloads only when diagnostics or the control plane materialize
        host views). The superstep consumes its input, so the fresh outputs
        are stored back into the residency when the steps end."""
        fn, levels = self._fused_program()
        res = self.arena.device()
        # the residency hands its stacks over in a list, which the superstep
        # empties: a level's pre-step stack is freed once its successor
        # exists, so a coarse step holds two copies of the state, not three
        pdfs = [res.take(l, "pdf") for l in levels]
        nsub = 1 << levels[-1]
        with _TR.stage("fused", cat="stage", coarse_steps=coarse_steps) as sp:
            for _ in range(coarse_steps):
                pdfs = list(fn(pdfs))
            # repro: host-ok(timing fence: StageStats seconds must not hide queued device work)
            synchronize(self.device)
            for l, arr in zip(levels, pdfs):
                res.store(l, "pdf", arr)
        self.sim.data_stats["fused"].add(
            StageStats(seconds=sp.seconds, exchange_rounds=coarse_steps * nsub)
        )


@_register
class ShardedEngine(StepEngine):
    """The rank-partitioned host data plane: per-rank arenas, in-place
    intra-rank halo copies, cross-rank faces as batched p2p messages."""

    mode = "sharded"

    def __init__(self, sim: "AMRLBM") -> None:
        super().__init__(sim)
        self.arenas = RankArenas(sim.fields, sim.cfg.nranks)
        # (arenas version, the whole forest's compiled rank plan), used by
        # the device-resident subclasses
        self._rank_plan: tuple | None = None

    def _rank_slots(self) -> dict[int, dict[int, dict[int, int]]]:
        per_rank = self.arenas.per_rank
        return {r: {l: per_rank[r].slots(l) for l in per_rank[r].levels()} for r in range(self.cfg.nranks)}

    def _whole_rank_plan(self):
        """The compiled rank plan of every level in use, cached until the
        arenas' next adoption: the device-resident sharded engines' host
        fill after an AMR event runs it, and their next programs cut each
        pattern's plan from it (``lbm/plans.py``), one compile an event."""
        version = self.arenas.version
        if self._rank_plan is None or self._rank_plan[0] != version:
            levels = sorted(self.sim.forest.levels_in_use())
            plan = compile_rank_forest_plan(self.sim.forest, self.sim.fields, self._rank_slots(), levels)
            self._rank_plan = (version, plan)
        return self._rank_plan[1]

    def _exchange_whole_plan(self) -> None:
        """The whole forest's host fill through :meth:`_whole_rank_plan`, in
        place on the ranks' host stacks, its payloads through the ``Comm``
        fabric: bitwise :func:`~.halo.fill_ghost_layers_sharded`'s fill,
        with its messages and bytes."""
        self.sync_caches()
        comm = self.sim.comm
        s0 = comm.stats.summary()
        per_rank = self.arenas.per_rank
        bufs = {r: {l: per_rank[r].buffer(l, "pdf") for l in per_rank[r].levels()} for r in range(self.cfg.nranks)}
        with _TR.stage("halo", cat="stage") as sp:
            run_rank_plan_on_host(self._whole_rank_plan(), bufs, comm)
        self.sim.data_stats["halo"].add(StageStats.delta(s0, comm.stats.summary(), sp.seconds))

    def _group_mask(self, level: int, ranks: tuple[int, ...]) -> torch.Tensor:
        """Device mask for a batched group of rank buffers."""
        self.sync_caches()
        key = (level, ranks)
        m = self._mask_dev.get(key)
        if m is None:
            parts = [self.arenas.buffer(r, level, "mask") for r in ranks]
            host = parts[0] if len(parts) == 1 else np.concatenate(parts)
            m = torch.from_numpy(host).to(self.device, copy=True)
            self._mask_dev[key] = m
        return m

    def exchange_ghosts(self, active: set[int] | None = None) -> None:
        self.sync_caches()
        token = self.storage_version()
        comm = self.sim.comm
        s0 = comm.stats.summary()
        with _TR.stage("halo", cat="stage") as sp:
            fill_ghost_layers_sharded(
                self.sim.forest,
                self.sim.fields,
                comm,
                fields=("pdf",),
                levels=active,
                plan_cache=self._halo_plans,
                cache_token=token,
            )
        self.sim.data_stats["halo"].add(StageStats.delta(s0, comm.stats.summary(), sp.seconds))

    def step_level(self, level: int) -> None:
        """One kernel call per rank per level, batched where shapes agree:
        ranks whose level buffers hold the same block count share one call
        on their concatenated buffers."""
        per_rank = [
            (r, buf)
            for r in range(self.cfg.nranks)
            if (buf := self.arenas.buffer(r, level, "pdf")) is not None and buf.shape[0] > 0
        ]
        by_count: dict[int, list[tuple[int, np.ndarray]]] = {}
        for r, buf in per_rank:
            by_count.setdefault(buf.shape[0], []).append((r, buf))
        stepper = self._stepper(level)
        for nblocks, group in sorted(by_count.items()):
            ranks = tuple(r for r, _ in group)
            mask = self._group_mask(level, ranks)
            if len(group) == 1:
                stepper(group[0][1], mask)  # in place on the rank's buffer
                continue
            cat = np.concatenate([buf for _, buf in group])
            stepper(cat, mask)
            for i, (_r, buf) in enumerate(group):
                np.copyto(buf, cat[i * nblocks : (i + 1) * nblocks])

    def particle_batches(self, level: int):
        """Per-rank batches over that rank's own buffers, so a rank's tracers
        read only the rank's own memory."""
        out = []
        for r in range(self.cfg.nranks):
            arena = self.arenas.per_rank[r]
            pdf = arena.buffer(level, "pdf")
            if pdf is None or pdf.shape[0] == 0:
                continue
            blocks = [b for b in self.sim.forest.local_blocks(r).values() if b.level == level]
            out.append((pdf, arena.buffer(level, "mask"), arena.slots(level), blocks))
        return out


@dataclass
class _RankPrograms:
    """Per-rank substep programs for one (storage version, level set): emit
    and absorb closures per (activity pattern, rank) plus the message
    routing tables the advance loop feeds the ``Comm`` fabric from."""

    levels: tuple[int, ...]
    nsub: int
    pattern: list[int]
    ranks: tuple[int, ...]
    rank_levels: dict[int, tuple[int, ...]]
    emits: dict[int, dict[int, Callable]] = field(default_factory=dict)
    absorbs: dict[int, dict[int, Callable]] = field(default_factory=dict)
    # interior/boundary split pair (exclusive with absorbs[p][r]): interior
    # steps while the host routes payloads, boundary consumes the messages
    interiors: dict[int, dict[int, Callable]] = field(default_factory=dict)
    boundaries: dict[int, dict[int, Callable]] = field(default_factory=dict)
    sends: dict[int, dict[int, list]] = field(default_factory=dict)
    recvs: dict[int, dict[int, list]] = field(default_factory=dict)
    has_messages: dict[int, bool] = field(default_factory=dict)
    # the compiled rank plan of each activity pattern and the slot map they
    # index, for the protocol verifier
    plans: dict[int, object] = field(default_factory=dict)
    rank_slots: dict[int, dict[int, dict[int, int]]] = field(default_factory=dict)
    # each rank's shared halo stepper factory (its ``steps()``: the maps)
    factories: dict[int, Callable] = field(default_factory=dict)


@_register
class FusedShardedEngine(ShardedEngine):
    """Device-resident rank-sharded mode: each rank's substep runs over its
    own :class:`~..core.fields.DeviceResidency`, and cross-rank halo patches
    travel as device-built per-rank-pair message tensors through ``Comm`` —
    one p2p message per neighbouring pair per exchange, zero host<->device
    transfers per substep (host contact only at AMR events).

    ``cfg.overlap_split`` resolves once, here: ``None`` splits a rank's
    substep into interior and boundary halves exactly when the engine runs
    on a card, where the host routes messages while the interior stencils
    run; on the CPU nothing runs concurrently, so the unsplit absorb is
    kept.
    """

    mode = "fused_sharded"

    def __init__(self, sim: "AMRLBM") -> None:
        super().__init__(sim)
        for arena in self.arenas.per_rank:
            arena.device(self.device)
        split = sim.cfg.overlap_split
        self.split = self.device.type == "cuda" if split is None else bool(split)
        self._programs_cache: _RankPrograms | None = None
        self._programs_key: tuple | None = None

    def masks_refreshed(self) -> None:
        super().masks_refreshed()
        for arena in self.arenas.per_rank:
            arena.device().drop(name="mask")
        self._programs_cache = None
        self._programs_key = None

    def materialize_host(self) -> None:
        for arena in self.arenas.per_rank:
            arena.device().flush()

    def residencies(self) -> list:
        return [arena.device() for arena in self.arenas.per_rank]

    def exchange_ghosts(self, active: set[int] | None = None) -> None:
        """The whole forest's host fill (after an AMR event, before tracers),
        through the compiled plan the next programs' patterns are cut from;
        the programs fill every substep's ghosts themselves."""
        assert active is None, "the host fills the whole forest"
        self._exchange_whole_plan()

    def _programs(self) -> _RankPrograms:
        forest = self.sim.forest
        levels = tuple(sorted(forest.levels_in_use()))
        key = (self.arenas.version, levels)
        if self._programs_cache is not None and self._programs_key == key:
            return self._programs_cache
        with _TR.span("build:rank_programs", cat="compile", version=self.arenas.version):
            self._programs_cache = self._build_programs(forest, levels)
        self._programs_key = key
        return self._programs_cache

    def _build_programs(self, forest: "BlockForest", levels: tuple[int, ...]) -> _RankPrograms:
        lmax = levels[-1]
        nsub = 1 << lmax
        per_rank = self.arenas.per_rank
        ranks = tuple(r for r in range(self.cfg.nranks) if per_rank[r].levels())
        rank_levels = {r: tuple(per_rank[r].levels()) for r in ranks}
        rank_slots = {r: {l: per_rank[r].slots(l) for l in rank_levels[r]} for r in ranks}
        # one halo stepper factory a rank, shared by its patterns: a level
        # whose rows are the same in several patterns gets one map
        factories = {
            # repro: host-ok(mask copy at program build, once per arena version)
            r: shared_halo_steps(self._halo_stepper_factory({l: np.array(per_rank[r].buffer(l, "mask"))
                                                             for l in rank_levels[r]}))
            for r in ranks
        }
        progs = _RankPrograms(levels=levels, nsub=nsub, pattern=substep_patterns(lmax), ranks=ranks,
                              rank_levels=rank_levels, rank_slots=rank_slots, factories=factories)
        backend = self.cfg.kernel_backend
        plans = rank_pattern_plans(self._whole_rank_plan(), levels)
        for p in range(lmax + 1):
            active = {l for l in levels if l >= lmax - p}
            plan = plans[p]
            progs.plans[p] = plan
            progs.has_messages[p] = bool(plan.messages)
            for d in (progs.emits, progs.absorbs, progs.interiors, progs.boundaries, progs.sends, progs.recvs):
                d[p] = {}
            for r in ranks:
                idx = {l: i for i, l in enumerate(rank_levels[r])}
                res = per_rank[r].device()
                sends = [m for m in plan.messages if m.src_rank == r]
                recvs = [m for m in plan.messages if m.dst_rank == r]
                progs.sends[p][r] = sends
                progs.recvs[p][r] = recvs
                emit = make_rank_emit(sends, idx, self.device)
                if emit is not None:
                    progs.emits[p][r] = emit
                local = plan.local.get(r)
                rank_active = active & set(rank_levels[r])
                if not recvs and not rank_active and not (local and local.ops):
                    # the rank is idle in this pattern (it owns only levels
                    # that do not step in it): no program, no dispatch
                    continue
                kw = dict(
                    steppers={l: self._fused_stepper(l) for l in rank_levels[r]},
                    masks={l: res.fetch(l, "mask") for l in rank_levels[r]},
                    active_levels=rank_active,
                    backend=backend,
                    device=self.device,
                    halo_stepper_factory=factories[r],
                )
                bnd = boundary_slot_sets(recvs, {l: kw["masks"][l] for l in rank_active})
                n_interior = sum(kw["masks"][l].shape[0] - len(bnd.get(l, ())) for l in rank_active)
                if self.split and recvs and n_interior > 0:
                    # boundary blocks wait for inbound payloads; interior
                    # blocks do not — split so the host-side routing
                    # overlaps the interior stepping dispatched before it
                    progs.interiors[p][r], progs.boundaries[p][r] = make_rank_absorb_split(
                        recvs, local, idx, **kw
                    )
                else:
                    progs.absorbs[p][r] = make_rank_absorb(recvs, local, idx, **kw)
        return progs

    def advance(self, coarse_steps: int) -> None:
        """Run whole coarse steps with per-rank device programs: the only
        per-substep host involvement is routing the device-resident message
        tensors through ``Comm`` (the fabric sees exactly the p2p shape of
        the host-sharded mode, with identical byte accounting).

        Dispatch order per substep: every rank's ``emit`` (payload gathers)
        and ``interior`` half are launched *before* the host touches the
        fabric, so the Python-side send/exchange/routing runs while the
        device works through them (launches are asynchronous, all on one
        stream); only the ``boundary``/``absorb`` programs, which consume
        inbound payloads, wait for routing."""
        progs = self._programs()
        comm = self.sim.comm
        res = {r: self.arenas.per_rank[r].device() for r in progs.ranks}
        # the residencies hand their stacks over: a rank's pre-step stacks
        # are freed once its programs return their successors, so a coarse
        # step holds two copies of the state, not three
        pdfs = {r: tuple(res[r].take(l, "pdf") for l in progs.rank_levels[r]) for r in progs.ranks}
        s0 = comm.stats.summary()
        with _TR.stage("fused", cat="stage", coarse_steps=coarse_steps) as st:
            for _ in range(coarse_steps):
                for s in range(progs.nsub):
                    p = progs.pattern[s]
                    overlapped = bool(progs.interiors[p])
                    payloads = []
                    for r in progs.ranks:
                        emit = progs.emits[p].get(r)
                        if emit is not None:
                            with _TR.span("emit", cat="substep", rank=r, substep=s, pattern=p):
                                payloads.append((r, emit(pdfs[r])))
                    pending = {}
                    for r in progs.ranks:
                        interior = progs.interiors[p].get(r)
                        if interior is not None:
                            with _TR.span("interior", cat="substep", rank=r, substep=s, pattern=p):
                                pending[r] = interior(pdfs[r])
                    with _TR.span("route", cat="substep", substep=s, pattern=p, overlapped=overlapped) as rt:
                        nbytes = 0
                        for r, arrs in payloads:
                            for m, arr in zip(progs.sends[p][r], arrs):
                                comm.send(m.src_rank, m.dst_rank, "halo", (m.key, arr), nbytes=m.nbytes)
                                nbytes += m.nbytes
                        by_key = {}
                        if progs.has_messages[p]:
                            for _dst, msgs in comm.exchange().items():
                                for _tag, (mkey, arr) in msgs:
                                    by_key[mkey] = arr
                        rt.set(bytes=nbytes)
                    for r in progs.ranks:
                        msgs = tuple(by_key[m.key] for m in progs.recvs[p][r])
                        boundary = progs.boundaries[p].get(r)
                        if boundary is not None:
                            with _TR.span("absorb", cat="substep", rank=r, substep=s, pattern=p, split=True):
                                pdfs[r] = boundary(pending.pop(r), msgs)
                            continue
                        absorb = progs.absorbs[p].get(r)
                        if absorb is None:  # rank is idle in this pattern
                            continue
                        with _TR.span("absorb", cat="substep", rank=r, substep=s, pattern=p, split=False):
                            pdfs[r] = absorb(pdfs[r], msgs)
            # repro: host-ok(timing fence: StageStats seconds must not hide queued device work)
            synchronize(self.device)
            for r in progs.ranks:
                for l, arr in zip(progs.rank_levels[r], pdfs[r]):
                    res[r].store(l, "pdf", arr)
        stage = StageStats.delta(s0, comm.stats.summary(), st.seconds)
        # one logical ghost-exchange round per substep, as the fused engine
        # reports (the Comm superstep count is 0 at one rank)
        stage.exchange_rounds = coarse_steps * progs.nsub
        self.sim.data_stats["fused"].add(stage)


def resolve_rank_devices(rank_devices, nranks: int, device: torch.device) -> tuple[torch.device, ...]:
    """One device per rank: the first ``nranks`` entries of ``rank_devices``.

    ``None`` means ``("cpu",) * nranks`` when the engine runs on the CPU,
    and every visible card once (``cuda:0 ... cuda:{k-1}``) when it runs on
    the card. Fewer devices than ranks raise: ranks never wrap around onto
    a card silently, so sharing one card is always an explicit
    ``rank_devices=("cuda:0",) * nranks``. Every rank device must be of the
    engine's device type."""
    if rank_devices is None:
        if device.type == "cpu":
            rank_devices = ("cpu",) * nranks
        else:
            rank_devices = tuple(f"cuda:{i}" for i in range(torch.cuda.device_count()))
    if len(rank_devices) < nranks:
        raise RuntimeError(
            f"device_sharded needs one device per rank: nranks={nranks} but "
            f"{len(rank_devices)} rank devices ({', '.join(map(str, rank_devices)) or 'none'}). "
            f"Pass rank_devices with {nranks} entries (rank_devices=('cuda:0',) * {nranks} "
            "shares one card between the ranks), or lower cfg.nranks."
        )
    out = tuple(torch.device(d) for d in rank_devices[:nranks])
    for d in out:
        if d.type != device.type:
            raise ValueError(f"rank device {d} is not a {device.type} device, as the engine's {device} is")
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"rank device {d} does not exist: {torch.cuda.device_count()} cards are visible")
    return out


@dataclass
class _DevicePrograms:
    """One device superstep for a (storage version, level set), plus the
    per-pattern message tables the advance loop feeds
    :meth:`~..core.comm.DeviceComm.ppermute` accounting from."""

    levels: tuple[int, ...]
    counts: dict[int, int]
    nsub: int
    pattern: list[int]
    fn: Callable
    messages: dict[int, tuple]
    rounds: dict[int, int]
    pad_bytes: dict[int, int]


@dataclass
class RankTransfers:
    """Host<->device copies of one rank's padded stacks, in the counters a
    :class:`~..core.fields.DeviceResidency` keeps for the other device
    modes."""

    h2d_transfers: int = 0
    h2d_bytes: int = 0
    d2h_transfers: int = 0
    d2h_bytes: int = 0


@_register
class DeviceShardedEngine(ShardedEngine):
    """Real device ranks: one device per rank.

    Where ``fused_sharded`` simulates the distributed data plane (per-rank
    programs on one device, payloads routed through the host ``Comm``), this
    mode keeps each rank's block stacks on the rank's own device
    (``cfg.rank_devices``, resolved once, here, by
    :func:`resolve_rank_devices`) and moves every halo payload device to
    device inside :func:`~..kernels.lbm_collide.ops.make_device_superstep`,
    with no host involvement per substep, not even routing. One process
    drives every rank: the control plane (AMR, balancing, migration) stays
    on the host over a :class:`~..core.comm.DeviceComm`, as the JAX
    package's single controller does over its mesh. Ranks on distinct cards
    exchange payloads by peer copies; ranks that share a card (an explicit
    ``rank_devices=("cuda:0",) * n``) by on-device copies.

    Equal-blocks-per-rank padding: every level's stack is padded to the
    largest per-rank block count with all-WALL masks and weight-vector
    pdfs. All-WALL cells pass through the stencil unchanged, so pad slots
    stay as they are, and no plan reads or writes one
    (``verify_padded_plan``, asserted for every pattern's plan). The
    ``Comm`` fabric must be a ``DeviceComm`` (``AMRLBM`` wires it) so that
    the payload traffic lands in the same Table-1 counters as every other
    mode's.
    """

    mode = "device_sharded"

    def __init__(self, sim: "AMRLBM") -> None:
        super().__init__(sim)
        if not hasattr(sim.comm, "ppermute"):
            raise TypeError(
                "device_sharded requires a DeviceComm fabric so that its device-to-device payload "
                f"traffic is accounted; got {type(sim.comm).__name__}"
            )
        self.rank_devices = resolve_rank_devices(sim.cfg.rank_devices, sim.cfg.nranks, self.device)
        self.transfers = [RankTransfers() for _ in self.rank_devices]
        self._dev_programs: _DevicePrograms | None = None
        self._dev_programs_key: tuple | None = None
        self._dev_levels: tuple[int, ...] | None = None
        self._dev_pdfs: dict[int, tuple] | None = None
        self._dev_masks: dict[int, tuple] | None = None
        self._dev_version = -1
        self._host_stale = False  # device pdfs newer than the host arenas

    # -- storage / invalidation ------------------------------------------------
    def adopt(self, forest: "BlockForest") -> None:
        assert not self._host_stale, (
            "materialize_host() before adopt: device-resident steps would be lost rebinding the arenas"
        )
        super().adopt(forest)

    def masks_refreshed(self) -> None:
        super().masks_refreshed()
        # the superstep closes over the device masks
        self._dev_masks = None
        self._dev_programs = None
        self._dev_programs_key = None

    def residencies(self) -> list:
        return list(self.transfers)

    def materialize_host(self) -> None:
        if not self._host_stale:
            return
        with _TR.span("device:materialize_host", cat="transfer"):
            for r, stacks in self._dev_pdfs.items():
                for l, t in zip(self._dev_levels, stacks):
                    buf = self.arenas.buffer(r, l, "pdf")
                    if buf is not None and buf.shape[0]:
                        torch.from_numpy(buf).copy_(t[: buf.shape[0]])
                        self.transfers[r].d2h_transfers += 1
                        self.transfers[r].d2h_bytes += buf.nbytes
        self._host_stale = False

    def exchange_ghosts(self, active: set[int] | None = None) -> None:
        # host-visible ghost refresh (after an AMR event, before advection):
        # flush the device steps, then run the host exchange. The device
        # interiors stay current and their ghosts are filled again at the
        # next substep 0, so the device state is kept, as fused_sharded's
        assert active is None, "the host fills the whole forest"
        self.materialize_host()
        self._exchange_whole_plan()

    # -- programs --------------------------------------------------------------
    def _programs(self) -> _DevicePrograms:
        forest = self.sim.forest
        levels = tuple(sorted(forest.levels_in_use()))
        key = (self.arenas.version, levels)
        if self._dev_programs is not None and self._dev_programs_key == key:
            return self._dev_programs
        with _TR.span("build:device_programs", cat="compile", version=self.arenas.version):
            self._dev_programs = self._build_programs(forest, levels)
        self._dev_programs_key = key
        return self._dev_programs

    def _build_programs(self, forest: "BlockForest", levels: tuple[int, ...]) -> _DevicePrograms:
        lmax = levels[-1]
        rank_slots = self._rank_slots()
        counts = padded_block_counts(rank_slots, self.cfg.nranks)
        fs = self.sim.fields.fields["pdf"]
        row_bytes = int(np.prod(fs.shape, dtype=np.int64)) * np.dtype(fs.dtype).itemsize
        whole = self._whole_rank_plan()
        # every pattern's plan is a cut of the whole one: no index of the
        # whole plan may touch a padded slot
        bad = verify_padded_plan(whole, rank_slots)
        assert not bad, bad
        plans = rank_pattern_plans(whole, levels)
        schedules, messages, rounds_n, pad_bytes = {}, {}, {}, {}
        for p in range(lmax + 1):
            sched = schedule_ppermute_rounds(plans[p].messages)
            schedules[p], messages[p] = sched, plans[p].messages
            rounds_n[p] = len(sched)
            pad_bytes[p] = sum(rnd.pad_cells() for rnd in sched) * row_bytes
        self._ensure_device(levels, counts)
        fn = make_device_superstep(
            levels=levels,
            plans=plans,
            schedules=schedules,
            steppers={l: self._fused_stepper(l) for l in levels},
            masks=self._dev_masks,
            devices=dict(enumerate(self.rank_devices)),
            backend=self.cfg.kernel_backend,
            # each rank's halo steps read its padded device masks
            halo_stepper_factories={
                r: self._halo_stepper_factory(dict(zip(levels, self._dev_masks[r])), device)
                for r, device in enumerate(self.rank_devices)
            },
        )
        return _DevicePrograms(
            levels=levels, counts=counts, nsub=1 << lmax, pattern=substep_patterns(lmax), fn=fn,
            messages=messages, rounds=rounds_n, pad_bytes=pad_bytes,
        )

    # -- device residency ------------------------------------------------------
    def _padded(self, r: int, l: int, name: str, count: int, fill: torch.Tensor) -> torch.Tensor:
        """Rank ``r``'s level-``l`` stack of ``name`` on its device, padded
        to ``count`` slots of ``fill`` (broadcast over a slot); one counted
        upload of the rank's real blocks."""
        shape = (count, *self.sim.fields.fields[name].shape, *self.sim.spec.mask_shape)
        t = torch.empty(shape, dtype=fill.dtype, device=self.rank_devices[r])
        t[:] = fill.to(t.device)
        buf = self.arenas.buffer(r, l, name)
        if buf is not None and buf.shape[0]:
            t[: buf.shape[0]].copy_(torch.from_numpy(buf))
            self.transfers[r].h2d_transfers += 1
            self.transfers[r].h2d_bytes += buf.nbytes
        return t

    def _ensure_device(self, levels: tuple[int, ...], counts: dict[int, int]) -> None:
        """Upload the padded per-rank stacks, once per storage version (and
        the masks again after a mask refresh); called by every superstep
        build, so a current superstep implies current stacks."""
        version = self.arenas.version
        if self._dev_version != version or self._dev_levels != levels:
            assert not self._host_stale  # adopt() already enforces the flush
            self._dev_pdfs = None
            self._dev_masks = None
        lattice = self.sim.spec.lattice
        # pad slots hold the weight vector under all-WALL masks (see the
        # class docstring)
        # repro: host-ok(lattice weights are a host constant)
        w = torch.as_tensor(np.asarray(lattice.w, dtype=self.sim.fields.fields["pdf"].dtype))
        w = w.reshape((lattice.Q, 1, 1, 1))
        wall = torch.tensor(int(CellType.WALL), dtype=torch.int32)
        ranks = range(len(self.rank_devices))
        with _TR.span("device:upload", cat="transfer", version=version):
            if self._dev_pdfs is None:
                self._dev_pdfs = {r: tuple(self._padded(r, l, "pdf", counts[l], w) for l in levels) for r in ranks}
            if self._dev_masks is None:
                self._dev_masks = {r: tuple(self._padded(r, l, "mask", counts[l], wall) for l in levels) for r in ranks}
        self._dev_version = version
        self._dev_levels = levels

    def device_held_bytes_by_rank(self) -> list[int]:
        """Bytes of padded stepping state (pdf and mask stacks) on each
        rank's device, one entry a rank: equal on every rank by
        construction, which this asserts."""
        self._programs()  # builds the superstep, uploading the stacks
        held = [
            sum(t.numel() * t.element_size() for t in self._dev_pdfs[r] + self._dev_masks[r])
            for r in range(len(self.rank_devices))
        ]
        assert len(set(held)) == 1, f"padded stacks differ between rank devices: {held}"
        return held

    def device_held_bytes_per_rank(self) -> int:
        """Bytes of padded stepping state each rank's device holds, one
        ``int`` as the JAX package returns: the Table-1 boundedness quantity
        of this fabric (per rank: :meth:`device_held_bytes_by_rank`)."""
        return self.device_held_bytes_by_rank()[0]

    # -- stepping --------------------------------------------------------------
    def advance(self, coarse_steps: int) -> None:
        """Run whole coarse steps: upload once per storage version, then
        every substep's emits, payload copies and stencils run on the
        rank devices; the host only attributes the known message traffic to
        the ``DeviceComm`` counters."""
        progs = self._programs()  # a current superstep implies current device stacks
        comm = self.sim.comm
        s0 = comm.stats.summary()
        with _TR.stage("fused", cat="stage", coarse_steps=coarse_steps) as st:
            # handed over: the superstep empties the dict, and a rank's
            # pre-step stacks are freed once their successors exist, so a
            # coarse step holds two copies of the padded state, not three
            pdfs, self._dev_pdfs = self._dev_pdfs, None
            for _ in range(coarse_steps):
                with _TR.span("device_superstep", cat="substep", nsub=progs.nsub):
                    pdfs = progs.fn(pdfs)
                for p in progs.pattern:
                    if progs.messages[p]:
                        # repro: collective-ok(accounting mirror of the in-program payload copies — p2p bytes, not a collective)
                        comm.ppermute(progs.messages[p], rounds=progs.rounds[p], pad_bytes=progs.pad_bytes[p])
            # timing fence on every rank device
            for d in dict.fromkeys(self.rank_devices):
                # repro: host-ok(timing fence: StageStats seconds must not hide queued device work)
                synchronize(d)
            self._dev_pdfs = pdfs
        self._host_stale = True
        stage = StageStats.delta(s0, comm.stats.summary(), st.seconds)
        # one logical ghost exchange per substep, as the other fused engines
        # report, even where the fabric saw no cross-rank bytes
        stage.exchange_rounds = coarse_steps * progs.nsub
        self.sim.data_stats["fused"].add(stage)
