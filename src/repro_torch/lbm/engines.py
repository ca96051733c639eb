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

Modes of this port: ``restack`` (re-stack every substep, the conformance
oracle), ``arena`` (persistent per-level host buffers, uploaded and copied
back each substep) and ``fused`` (the whole coarse step on the device over a
:class:`~..core.fields.DeviceResidency`, no host transfer between AMR
events). The rank-sharded modes of the JAX package are not ported yet.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from ..core import LevelArena
from ..core.pipeline import StageStats
from ..device import resolve_device, synchronize
from ..kernels.lbm_collide.ops import (
    make_arena_stream_collide,
    make_fused_superstep,
    make_halo_stream_collide,
    make_stream_collide,
)
from ..telemetry import get_tracer
from .halo import compile_ghost_plan, fill_ghost_layers
from .lattice import omega_for_level

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..core.forest import BlockForest
    from .driver import AMRLBM

__all__ = ["StepEngine", "ENGINES", "NOT_PORTED", "make_engine"]

ENGINES: dict[str, type["StepEngine"]] = {}

# stepping modes of the JAX package that this port does not run yet, with
# the ROADMAP item that queues each
NOT_PORTED = {
    "sharded": "ROADMAP Queue 1.7 (rank-sharded engines)",
    "fused_sharded": "ROADMAP Queue 1.7 (rank-sharded engines)",
    "device_sharded": "ROADMAP Queue 1.9 (real device ranks)",
}

_TR = get_tracer()


def make_engine(sim: "AMRLBM") -> "StepEngine":
    mode = sim.cfg.stepping_mode
    if mode in NOT_PORTED:
        raise NotImplementedError(
            f"stepping_mode={mode!r} is not ported yet: {NOT_PORTED[mode]}"
        )
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
        self._steppers: dict[int, Callable] = {}
        self._fused_steppers: dict[int, Callable] = {}
        self._mask_dev: dict[int, torch.Tensor] = {}  # level -> device mask
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

    def _halo_stepper_factory(self, masks_host: dict[int, np.ndarray]):
        """``(level, fill, level_index) -> HaloStep`` builder for the
        halo-in-tile superstep; ``masks_host`` are host mask stacks (copied —
        the factory's constants must not alias mutable arena storage)."""

        def factory(level: int, fill, level_index: dict[int, int]):
            return make_halo_stream_collide(
                fill,
                level_index,
                mask=masks_host[level],
                device=self.device,
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
        return self.arena.version if self.arena is not None else -1

    def adopt(self, forest: "BlockForest") -> None:
        """Rebind storage after a topology change (AMR event, restore)."""
        if self.arena is not None:
            self.arena.adopt(forest)

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
        out = self._stepper(level)(f, m).cpu().numpy()
        for i, b in enumerate(blocks):
            b.data["pdf"] = out[i]


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

    def masks_refreshed(self) -> None:
        super().masks_refreshed()
        # host-side write: device mask copies (and the superstep that closed
        # over them) are stale
        self.arena.device().drop(name="mask")
        self._fused_fn = None
        self._fused_key = None

    def materialize_host(self) -> None:
        self.arena.device().flush()

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
            lmax = levels[-1]
            slots = {l: self.arena.slots(l) for l in levels}
            plans = {
                p: compile_ghost_plan(
                    forest,
                    self.sim.fields,
                    slots,
                    fields=("pdf",),
                    levels={l for l in levels if l >= lmax - p},
                )
                for p in range(lmax + 1)
            }
            res = self.arena.device()
            masks_host = {l: np.array(self.arena.buffer(l, "mask")) for l in levels}
            self._fused_fn = make_fused_superstep(
                levels=levels,
                plans=plans,
                steppers={l: self._fused_stepper(l) for l in levels},
                masks={l: res.fetch(l, "mask") for l in levels},
                halo_stepper_factory=self._halo_stepper_factory(masks_host),
            )
        self._fused_key = key
        return self._fused_fn, levels

    def advance(self, coarse_steps: int) -> None:
        """Run whole coarse steps on the device, zero host transfers in
        steady state (uploads only after AMR events / mask refreshes;
        downloads only when diagnostics or the control plane materialize
        host views). The superstep consumes its input tuple, so the fresh
        outputs are stored back into the residency immediately."""
        fn, levels = self._fused_program()
        res = self.arena.device()
        pdfs = tuple(res.fetch(l, "pdf") for l in levels)
        nsub = 1 << levels[-1]
        with _TR.stage("fused", cat="stage", coarse_steps=coarse_steps) as sp:
            for _ in range(coarse_steps):
                pdfs = fn(pdfs)
            # timing fence: StageStats seconds must not hide queued device work
            synchronize(self.device)
            for l, arr in zip(levels, pdfs):
                res.store(l, "pdf", arr)
        self.sim.data_stats["fused"].add(
            StageStats(seconds=sp.seconds, exchange_rounds=coarse_steps * nsub)
        )
