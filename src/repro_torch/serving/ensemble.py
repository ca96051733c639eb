"""Batched ensemble execution: many independent runs, one program.

The fused superstep is keyed only by forest topology and activity pattern —
nothing in it depends on *which* simulation is running beyond its
relaxation rate and wall velocity. An :class:`Ensemble` exploits that: it
takes M member simulations that share one forest topology, holds their
per-level arena buffers as ``(M, B, Q, X, Y, Z)`` device stacks, and
advances all of them with a single
:func:`~..kernels.lbm_collide.ops.make_ensemble_superstep` program whose
per-member physics parameters (tau, lid velocity) enter as operands. One
build per (topology, activity-pattern) key serves every member, and on the
``cuda`` backend one batched coarse step launches what one member's fused
coarse step launches: the hand-written kernels take the member axis.

Bitwise contract: the batched program runs each member through the same
kernels and the same fill tables as that member's solo ``fused`` run
(coefficients are rounded to the field dtype on the host by
``collision_coeffs`` either way, and every kernel is block-local and
fixed-order), so member ``i``'s state matches an independent solo fused run
with the same parameters bitwise, on either backend of the port.

Divergence: members own their control planes (criterion, AMR pipeline), so
refinement decisions may diverge. :meth:`Ensemble.adapt` materializes the
batch back into the member arenas, runs each member's own AMR cycle, and
regroups by the new topology keys — a diverging member simply splits into
its own (possibly singleton) ensemble, and every group keeps sharing the
same :class:`EnsembleProgramCache`.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from ..core.pipeline import StageStats
from ..device import resolve_device, synchronize
from ..kernels.lbm_collide.lbm_collide import member_coeffs
from ..kernels.lbm_collide.ops import BACKENDS, make_ensemble_superstep
from ..lbm.halo import compile_ghost_plan
from ..lbm.lattice import omega_for_level
from ..telemetry import get_tracer

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..core.forest import BlockForest
    from ..lbm.driver import AMRLBM, LidDrivenCavityConfig

__all__ = [
    "Ensemble",
    "EnsembleProgramCache",
    "ensemble_compat_key",
    "is_batchable",
    "topology_key",
]

_TR = get_tracer()


def topology_key(forest: "BlockForest") -> tuple[tuple[int, int], ...]:
    """Canonical (bid, level) signature of a forest's block structure.

    Ownership is deliberately excluded: the single-arena ghost plans and the
    slot layout depend only on which blocks exist, so two members balanced
    onto different owners still share one program.
    """
    return tuple(sorted((b.bid, b.level) for b in forest.all_blocks()))


def ensemble_compat_key(cfg: "LidDrivenCavityConfig") -> tuple:
    """Members are batchable together iff this key matches.

    Everything that shapes the program or the masks is included, and the
    resolved device: members batch only with members that run the same
    math (``kernel_backend``) on the same device. The per-member physics
    (``omega``, ``u_lid``) and control-plane knobs (refinement thresholds,
    balancer, nranks) are deliberately excluded — the former batch as
    operands, the latter only steer AMR decisions and are handled by
    divergence splits.
    """
    return (
        tuple(cfg.root_grid),
        tuple(cfg.cells_per_block),
        cfg.ghost,
        cfg.max_level,
        cfg.collision,
        cfg.kernel_backend,
        str(resolve_device(cfg.device)),
        id(cfg.obstacle_fn) if cfg.obstacle_fn is not None else None,
    )


def is_batchable(cfg: "LidDrivenCavityConfig") -> bool:
    """Can a job with this config join an ensemble batch?

    Requires a host-arena data plane (``arena``/``fused`` members expose the
    single global :class:`~..core.fields.LevelArena` the batch stacks) and
    no Lagrangian particles (tracer advection is per-member host work that
    would serialize the batch anyway). Either backend of the port batches:
    on ``cuda`` the ensemble runs the hand-written kernels' member axis, on
    ``ref`` their plain versions over the same axis, each bitwise a solo
    fused run of the same backend. The JAX package's clause about donated
    buffers drifting on XLA:CPU has no counterpart here: the port has no
    donation (the caching allocator's ping-pong took its place).
    """
    return (
        cfg.stepping_mode in ("arena", "fused")
        and cfg.kernel_backend in BACKENDS
        and cfg.particles is None
    )


class EnsembleProgramCache:
    """Ensemble supersteps keyed by (compat, topology, levels).

    Shared across every ensemble of a service so a divergence split (or a
    later job with a previously-seen topology) reuses existing programs.
    ``hits``/``misses`` feed the serving counters; the acceptance bar is one
    miss per distinct (topology, activity-pattern) key, total, per batch.
    """

    def __init__(self) -> None:
        self._programs: dict[tuple, Callable] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._programs)

    def get_or_build(self, key: tuple, build: Callable[[], Callable]) -> Callable:
        fn = self._programs.get(key)
        if fn is not None:
            self.hits += 1
            return fn
        self.misses += 1
        fn = self._programs[key] = build()
        return fn

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class Ensemble:
    """A batch of member simulations sharing one forest topology.

    The members keep their full control planes (forest, AMR pipeline,
    criterion, diagnostics); the ensemble owns only the batched data plane —
    an ``(M, B, Q, X, Y, Z)`` pdf stack per level on the members' device,
    refreshed lazily against the member arena versions and flushed back by
    :meth:`materialize` (mirroring :class:`~..core.fields.DeviceResidency`
    semantics, one batch axis up).
    """

    def __init__(
        self,
        members: list["AMRLBM"],
        *,
        programs: EnsembleProgramCache | None = None,
    ) -> None:
        assert members, "an ensemble needs at least one member"
        self.members = list(members)
        self.programs = programs if programs is not None else EnsembleProgramCache()
        m0 = self.members[0]
        self.compat = ensemble_compat_key(m0.cfg)
        self.device = m0.device
        topo0 = topology_key(m0.forest)
        for m in self.members:
            assert is_batchable(m.cfg), (
                f"job config not batchable (mode={m.cfg.stepping_mode!r}, "
                f"backend={m.cfg.kernel_backend!r}, particles={m.cfg.particles})"
            )
            assert ensemble_compat_key(m.cfg) == self.compat, "incompatible member"
            assert topology_key(m.forest) == topo0, "members must share a topology"
        self.stats = StageStats()
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        # batched device state: level -> (M, B, Q, X, Y, Z)
        self._dev: dict[int, torch.Tensor] = {}
        self._dev_levels: tuple[int, ...] | None = None
        self._dev_versions: tuple[int, ...] | None = None
        self._dev_newer = False
        # per-(levels) member coefficients (members are fixed for the
        # ensemble's lifetime, so only the level set can vary the coeffs)
        self._coeffs: dict[tuple[int, ...], dict] = {}

    # -- introspection ---------------------------------------------------------
    @property
    def size(self) -> int:
        return len(self.members)

    def topology(self) -> tuple[tuple[int, int], ...]:
        return topology_key(self.members[0].forest)

    # -- program ---------------------------------------------------------------
    def _program(self) -> tuple[Callable, tuple[int, ...]]:
        m0 = self.members[0]
        levels = tuple(sorted(m0.forest.levels_in_use()))
        key = (self.compat, self.topology(), levels)

        def build() -> Callable:
            with _TR.span("build:ensemble_superstep", cat="compile",
                          members=len(self.members)):
                return self._build_program(levels)

        return self.programs.get_or_build(key, build), levels

    def _build_program(self, levels: tuple[int, ...]) -> Callable:
        m0 = self.members[0]
        arena = m0.engine.arena
        lmax = levels[-1]
        slots = {l: arena.slots(l) for l in levels}
        plans = {
            p: compile_ghost_plan(
                m0.forest,
                m0.fields,
                slots,
                fields=("pdf",),
                levels={l for l in levels if l >= lmax - p},
            )
            for p in range(lmax + 1)
        }
        masks = {l: arena.buffer(l, "mask") for l in levels}
        for m in self.members[1:]:  # shared-mask precondition
            for l in levels:
                assert m.engine.arena.slots(l) == slots[l], "ensemble members must share a slot layout"
                assert np.array_equal(
                    m.engine.arena.buffer(l, "mask"), masks[l]
                ), "ensemble members must share cell-type masks"
        return make_ensemble_superstep(
            levels=levels,
            plans=plans,
            masks=masks,
            lattice=m0.spec.lattice,
            collision=m0.cfg.collision,
            backend=m0.cfg.kernel_backend,
            device=self.device,
        )

    def _member_coeffs(self, levels: tuple[int, ...]) -> dict:
        """level -> :class:`~..kernels.lbm_collide.lbm_collide.MemberCoeffs`
        of the members, built once per level set (a table on the device)."""
        cached = self._coeffs.get(levels)
        if cached is not None:
            return cached
        m0 = self.members[0]
        dtype = torch.from_numpy(m0.engine.arena.buffer(levels[0], "pdf")[:0]).dtype
        out = {
            l: member_coeffs(
                [omega_for_level(m.cfg.omega, l) for m in self.members],
                [m.cfg.u_lid for m in self.members],
                lattice=m0.spec.lattice,
                collision=m0.cfg.collision,
                dtype=dtype,
                device=self.device,
            )
            for l in levels
        }
        self._coeffs[levels] = out
        return out

    # -- batched residency -----------------------------------------------------
    def _fetch(self, levels: tuple[int, ...]) -> None:
        """Upload the member pdf buffers unless the device copy is current:
        each level's stack is allocated on the device once and each member's
        host buffer copied into its slice (no host-side stacking)."""
        versions = tuple(m.engine.arena.version for m in self.members)
        if self._dev_levels == levels and self._dev_versions == versions:
            return
        assert not self._dev_newer, (
            "member arenas rebound while the batched device state was newer; "
            "materialize() before adapting members externally"
        )
        self._dev = {}
        for l in levels:
            bufs = [m.engine.arena.buffer(l, "pdf") for m in self.members]
            stack = torch.empty((len(bufs), *bufs[0].shape), dtype=torch.from_numpy(bufs[0][:0]).dtype,
                                device=self.device)
            for i, buf in enumerate(bufs):
                stack[i].copy_(torch.from_numpy(buf))
                self.h2d_bytes += buf.nbytes
            self._dev[l] = stack
        self._dev_levels = levels
        self._dev_versions = versions

    def materialize(self) -> None:
        """Flush device-newer batched state back into the member arenas, in
        place, so every member's ``Block.data`` views are current
        (diagnostics, AMR, checkpointing all read host views)."""
        if not self._dev_newer:
            return
        versions = tuple(m.engine.arena.version for m in self.members)
        assert versions == self._dev_versions, (
            "member arenas rebound under unmaterialized device state"
        )
        for l in self._dev_levels:
            for i, m in enumerate(self.members):
                buf = m.engine.arena.buffer(l, "pdf")
                torch.from_numpy(buf).copy_(self._dev[l][i])
                self.d2h_bytes += buf.nbytes
        self._dev_newer = False

    # -- stepping --------------------------------------------------------------
    def advance(self, coarse_steps: int) -> None:
        """Advance every member by ``coarse_steps`` with one program call per
        coarse step for the whole batch."""
        if coarse_steps <= 0:
            return
        fn, levels = self._program()
        with _TR.stage("ensemble.advance", cat="serving",
                       members=len(self.members),
                       coarse_steps=coarse_steps) as sp:
            self._fetch(levels)
            coeffs = self._member_coeffs(levels)
            pdfs = tuple(self._dev[l] for l in levels)
            for _ in range(coarse_steps):
                pdfs = fn(pdfs, coeffs)
            # repro: host-ok(timing fence: advance latency is the serving metric)
            synchronize(self.device)
            for l, arr in zip(levels, pdfs):
                self._dev[l] = arr
        self._dev_newer = True
        nsub = 1 << levels[-1]
        self.stats.add(
            StageStats(
                seconds=sp.seconds,
                exchange_rounds=coarse_steps * nsub,
            )
        )
        for m in self.members:
            m.coarse_step += coarse_steps

    # -- AMR / divergence ------------------------------------------------------
    def adapt(self, force_rebalance: bool = False) -> list["Ensemble"]:
        """Run each member's own AMR cycle, then regroup by topology.

        Returns the list of ensembles to continue with: ``[self]`` when every
        member still shares one topology (the common case — device state is
        reused when no member's storage rebound), or fresh ensembles per
        topology group after a divergence split. All groups keep sharing
        ``self.programs``, so a split costs at most one new program per new
        (topology, activity-pattern) key.
        """
        self.materialize()
        for m in self.members:
            m.adapt(force_rebalance=force_rebalance)
        groups: dict[tuple, list["AMRLBM"]] = {}
        for m in self.members:
            groups.setdefault(topology_key(m.forest), []).append(m)
        if len(groups) == 1:
            return [self]
        return [
            Ensemble(g, programs=self.programs) for g in groups.values()
        ]
