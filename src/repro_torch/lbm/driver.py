"""AMR-coupled LBM simulation driver on PyTorch.

Couples the data plane (per-block grids, the fused stream+collide kernels,
halo exchange) with the control plane (the four-step AMR pipeline):

* per-level time stepping: a level-l block advances 2^l times per coarsest
  step with the level-scaled relaxation rate (acoustic scaling);
* every ``amr_interval`` coarse steps the refinement criterion is evaluated
  and one AMR cycle (mark -> proxy -> balance -> migrate) is executed;
* cell types are re-derived from the analytic domain geometry after every
  repartitioning, which restores the overlap-consistency invariant (octets
  of fine cells agree with the overlapping coarse cell) exactly.

Stepping modes (``LidDrivenCavityConfig.stepping_mode``), one
:class:`~.engines.StepEngine` each: ``"restack"`` (the conformance oracle),
``"arena"`` (default, persistent host buffers), ``"fused"`` (the whole
coarse step on the device), ``"sharded"`` (per-rank host arenas with p2p
halo messages), ``"fused_sharded"`` (per-rank device residency with
device-built p2p messages) and ``"device_sharded"`` (one device per rank,
``rank_devices``, with payloads moved device to device). The device is
resolved once, when the engine is built: ``device=None`` means the CUDA card
and raises without one.

Data-plane time is attributed in :attr:`AMRLBM.data_stats`: host modes fill
``"halo"`` / ``"step"``; the device-resident modes report wall time plus
exchange rounds (and, for ``fused_sharded``, the cross-rank p2p traffic)
under ``"fused"`` (host<->device transfer counts live on the arenas'
:class:`~..core.fields.DeviceResidency`).

With ``particles=ParticlesConfig(...)`` a Lagrangian tracer layer rides the
forest (:mod:`~..particles`): once per coarse step the tracers advect
through the block-local velocity field (RK2, trilinear) on the engine's
device and redistribute to their new block/rank over the ``Comm`` fabric
(attributed under ``data_stats["particles"]``). The batch source is an
engine hook (:meth:`~.engines.StepEngine.particle_batches`); the
device-resident engines flush their pdf stacks to the host first, as
diagnostics do, and the advection uploads each batch again. Those bytes are
counted in :attr:`AMRLBM.particle_transfer_bytes`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..core import (
    AMRPipeline,
    Comm,
    DeviceComm,
    ForestGeometry,
    SFCBalancer,
    make_uniform_forest,
    recompute_weights,
)
from ..balancing import IndexedDiffusionBalancer
from ..core.forest import Block, BlockForest
from ..core.pipeline import StageStats
from ..kernels.lbm_collide.ops import BACKENDS
from ..kernels.lbm_collide.ref import equilibrium
from ..particles import (
    ParticlesConfig,
    advect_block_batch,
    particle_block_weight,
    particle_proxy_weight,
    redistribute_particles,
    register_particles,
    seed_particles,
)
from ..particles import total_particles as _forest_total_particles
from ..telemetry import get_tracer
from .criteria import VelocityGradientCriterion, macroscopic
from .engines import make_engine
from .grid import CellType, LBMBlockSpec, block_world_box, make_lbm_fields
from .lattice import D3Q19

__all__ = ["LidDrivenCavityConfig", "AMRLBM"]

_TR = get_tracer()


@dataclass
class LidDrivenCavityConfig:
    root_grid: tuple[int, int, int] = (2, 2, 2)
    cells_per_block: tuple[int, int, int] = (8, 8, 8)
    ghost: int = 1
    nranks: int = 4
    omega: float = 1.6
    u_lid: tuple[float, float, float] = (0.05, 0.0, 0.0)
    collision: str = "trt"
    max_level: int = 2
    refine_upper: float = 0.06
    refine_lower: float = 0.015
    balancer: str = "diffusion-pushpull"  # | "diffusion-push" | "morton" | "hilbert"
    # "cuda": the hand-written kernels (their plain versions for CPU
    # tensors); "ref": the plain PyTorch versions everywhere
    kernel_backend: str = "cuda"
    # None resolves once, at engine build, to "cuda" and raises without a
    # card; pass "cpu" to run the plain path on the host
    device: str | None = None
    # interior/boundary split of the fused_sharded substep (overlaps host
    # message routing with interior stepping): None resolves once, at
    # engine build, to "split iff the engine's device is a card"
    overlap_split: bool | None = None
    # device_sharded: one device per rank, the first nranks entries. None
    # resolves once, at engine build, to ("cpu",) * nranks on the CPU and to
    # every visible card once on the card; fewer devices than ranks raise.
    # Ranks share a card only when asked: rank_devices=("cuda:0",) * nranks
    rank_devices: tuple[str, ...] | None = None
    stepping_mode: str = "arena"  # | "fused" | "sharded" | "fused_sharded" | "device_sharded" | "restack"
    obstacle_fn: Callable[[np.ndarray], np.ndarray] | None = None  # (N,3)->bool
    # optional Lagrangian tracer layer (repro_torch.particles); None disables it
    particles: ParticlesConfig | None = None


def _make_balancer(name: str):
    if name == "morton":
        return SFCBalancer(order="morton", per_level=True)
    if name == "hilbert":
        return SFCBalancer(order="hilbert", per_level=True)
    if name == "diffusion-push":
        return IndexedDiffusionBalancer(mode="push", flow_iterations=15, max_main_iterations=20)
    if name == "diffusion-pushpull":
        return IndexedDiffusionBalancer(mode="pushpull", flow_iterations=5, max_main_iterations=20)
    raise ValueError(name)


class AMRLBM:
    def __init__(self, cfg: LidDrivenCavityConfig):
        self.cfg = cfg
        if cfg.kernel_backend not in BACKENDS:
            raise ValueError(f"kernel_backend {cfg.kernel_backend!r} not in {BACKENDS}")
        for n in cfg.cells_per_block:
            # even cells keep octant splits and 2:1 halo regions cell-aligned
            if n <= 0 or n % 2:
                raise ValueError("cells per block must be even (octant split + halo alignment)")
        self.spec = LBMBlockSpec(cells=cfg.cells_per_block, ghost=cfg.ghost, lattice=D3Q19)
        self.geom = ForestGeometry(root_grid=cfg.root_grid, max_level=12)
        self.fields = make_lbm_fields(self.spec)
        self.registry = self.fields  # typed registry drives all subsystems
        # device_sharded moves halo payloads device to device; the DeviceComm
        # fabric attributes those bytes into the same counters
        comm_cls = DeviceComm if cfg.stepping_mode == "device_sharded" else Comm
        self.comm = comm_cls(cfg.nranks)
        # Lagrangian tracers: the particle set registers as one more
        # block-data item (migration comes for free) and installs the
        # cells + alpha*N load model into the pipeline
        self._block_weight_fn = None
        proxy_weight_fn = None
        if cfg.particles is not None:
            register_particles(self.fields, self.geom)
            self._block_weight_fn = particle_block_weight(cfg.cells_per_block, cfg.particles.alpha)
            proxy_weight_fn = particle_proxy_weight(self.geom, cfg.cells_per_block, cfg.particles.alpha)
        self.pipeline = AMRPipeline(
            balancer=_make_balancer(cfg.balancer),
            registry=self.registry,
            weight_fn=proxy_weight_fn,
            block_weight_fn=self._block_weight_fn,
        )
        self.criterion = VelocityGradientCriterion(
            spec=self.spec,
            upper=cfg.refine_upper,
            lower=cfg.refine_lower,
            max_level=cfg.max_level,
        )
        self.forest: BlockForest = make_uniform_forest(self.geom, cfg.nranks, level=0)
        # data-plane stage attribution; the fused engine reports its wall
        # time + exchange rounds under "fused" (halo and step are one there)
        self.data_stats: dict[str, StageStats] = {
            "halo": StageStats(),
            "step": StageStats(),
            "fused": StageStats(),
            "particles": StageStats(),
        }
        # cumulative tracer counters, and the bytes the tracer steps moved
        # between host and device (flushes, advection uploads, velocities)
        self.particles_advected = 0
        self.particles_moved = 0
        self.particle_transfer_bytes = {"h2d": 0, "d2h": 0}
        # the data plane: storage, steppers, plan/mask caches, the superstep
        # and the per-mode advance loop all live on the engine
        self.engine = make_engine(self)
        self._pdf0 = None
        for blk in self.forest.all_blocks():
            self._init_block(blk)
        if cfg.particles is not None:
            seed_particles(
                self.forest,
                self.geom,
                per_block=cfg.particles.per_block,
                seed=cfg.particles.seed,
                region=cfg.particles.region,
            )
            recompute_weights(self.forest, self._block_weight_fn)
        self.engine.adopt(self.forest)
        self.refresh_masks()
        self.coarse_step = 0
        self.amr_cycles = 0

    @property
    def device(self) -> torch.device:
        return self.engine.device

    @property
    def arena(self):
        """The single global :class:`LevelArena` (arena/fused engines)."""
        return self.engine.arena

    @property
    def arenas(self):
        """The per-rank :class:`RankArenas` (sharded engines)."""
        return self.engine.arenas

    # -- block initialization & masks ----------------------------------------
    def _init_block(self, blk: Block) -> None:
        if self._pdf0 is None:  # the fluid at rest, the same in every block
            rho = torch.ones(self.spec.mask_shape, dtype=torch.float32)
            u = torch.zeros((3, *self.spec.mask_shape), dtype=torch.float32)
            self._pdf0 = equilibrium(rho, u, self.spec.lattice).numpy()
        blk.data["pdf"] = self._pdf0.copy()
        blk.data["mask"] = self.fields.alloc("mask")

    def _cell_axes(self, blk: Block) -> list[np.ndarray]:
        """World coordinates of the (ghosted) cell centers along each axis."""
        lo, hi = block_world_box(self.geom, blk.bid)
        n = np.asarray(self.spec.cells, dtype=np.float64)
        h = (hi - lo) / n
        g = self.spec.ghost
        return [lo[d] + (np.arange(-g, n[d] + g) + 0.5) * h[d] for d in range(3)]

    def _cell_centers(self, blk: Block) -> np.ndarray:
        """World coordinates of all (ghosted) cell centers, shape (X,Y,Z,3)."""
        return np.stack(np.meshgrid(*self._cell_axes(blk), indexing="ij"), axis=-1)

    def refresh_masks(self) -> None:
        """Re-derive cell types from the analytic geometry (domain walls, the
        moving lid at the top z face, optional obstacles). Writes in place so
        arena views stay bound; the engine's device mask state is invalidated.
        The walls and the lid test each axis's centers once and broadcast
        (the same comparisons as on the full grid of centers, which only an
        obstacle function needs)."""
        top = float(self.geom.root_grid[2])
        for blk in self.forest.all_blocks():
            x, y, z = self._cell_axes(blk)
            mask = np.zeros((x.size, y.size, z.size), dtype=np.int32)
            outside = (
                ((x < 0.0) | (x > self.geom.root_grid[0]))[:, None, None]
                | ((y < 0.0) | (y > self.geom.root_grid[1]))[None, :, None]
                | (z < 0.0)[None, None, :]
            )
            mask[np.broadcast_to(outside, mask.shape)] = CellType.WALL
            mask[:, :, z > top] = CellType.LID
            if self.cfg.obstacle_fn is not None:
                xyz = self._cell_centers(blk)
                obst = self.cfg.obstacle_fn(xyz.reshape(-1, 3)).reshape(mask.shape)
                mask[obst & (mask == 0)] = CellType.WALL
            blk.data["mask"][...] = mask
        self.engine.masks_refreshed()

    def materialize_host(self) -> None:
        """Flush device-newer buffers into the host arena so every
        ``Block.data`` view is current (fused mode; a no-op otherwise).
        Diagnostics and :meth:`adapt` call this automatically."""
        self.engine.materialize_host()

    # -- Lagrangian tracers -----------------------------------------------------
    def _transferred(self) -> tuple[int, int]:
        res = self.engine.residencies()
        return sum(r.h2d_bytes for r in res), sum(r.d2h_bytes for r in res)

    def _step_particles(self) -> None:
        """Advect tracers through the end-of-step velocity field and route
        escapees to their new block/rank (batched p2p, one message per rank
        pair). Runs once per coarse step in every stepping mode."""
        t0 = self._transferred()
        self.materialize_host()  # device modes: host pdf views must be current
        # Ghost layers must be a deterministic function of the (mode-
        # identical) interiors so interpolation reads the same values in
        # every mode. The next substep's exchange overwrites them again —
        # the device-resident engines fill every level's ghosts at substep 0
        # before any stencil — so this host-side write needs no residency
        # drop.
        self.engine.exchange_ghosts()
        traffic = {"h2d": 0, "d2h": 0}
        s0 = self.comm.stats.summary()
        with _TR.stage("particles", cat="stage") as sp:
            advected = 0
            for level in self.forest.levels_in_use():
                for pdf, mask, slots, blocks in self.engine.particle_batches(level):
                    advected += advect_block_batch(
                        pdf,
                        mask,
                        self.spec.lattice,
                        self.geom,
                        blocks,
                        slots,
                        level=level,
                        cells=self.spec.cells,
                        ghost=self.spec.ghost,
                        device=self.device,
                        traffic=traffic,
                    )
            moved, _cross_bytes = redistribute_particles(
                self.forest, self.geom, self.comm, boundary=self.cfg.particles.boundary
            )
        t1 = self._transferred()
        self.particle_transfer_bytes["h2d"] += traffic["h2d"] + t1[0] - t0[0]
        self.particle_transfer_bytes["d2h"] += traffic["d2h"] + t1[1] - t0[1]
        self.particles_advected += advected
        self.particles_moved += moved
        self.data_stats["particles"].add(StageStats.delta(s0, self.comm.stats.summary(), sp.seconds))

    def advance(self, coarse_steps: int = 1) -> None:
        """Advance by coarse time steps with per-level substepping."""
        self.engine.sync_caches()
        if self.cfg.particles is None:
            self.engine.advance(coarse_steps)
            self.coarse_step += coarse_steps
            return
        for _ in range(coarse_steps):
            self.engine.advance(1)
            self.coarse_step += 1
            self._step_particles()

    # -- AMR ------------------------------------------------------------------
    def adapt(self, force_rebalance: bool = False):
        """Evaluate the refinement criterion and run one AMR cycle."""
        self.materialize_host()  # criterion + migration read host views
        self.forest, report = self.pipeline.run_cycle(
            self.forest, self.comm, self.criterion, force_rebalance=force_rebalance
        )
        if report.executed:
            self.amr_cycles += 1
            _TR.instant(
                "amr.event", cat="amr", cycle=self.amr_cycles,
                blocks=self.forest.num_blocks(),
            )
            self.engine.adopt(self.forest)  # repack/rebuild storage, rebind views
            self.engine.sync_caches()
            self.refresh_masks()
            self.engine.exchange_ghosts()
        return report

    def run(self, coarse_steps: int, amr_interval: int = 4) -> None:
        for i in range(coarse_steps):
            self.advance(1)
            if (i + 1) % amr_interval == 0:
                self.adapt()

    # -- diagnostics -----------------------------------------------------------
    def _interior(self, arr: np.ndarray) -> np.ndarray:
        """Interior (non-ghost) slice of a per-block array (ghost-0 safe)."""
        return self.spec.interior(arr)

    def total_mass(self) -> float:
        self.materialize_host()
        total = 0.0
        for b in self.forest.all_blocks():
            interior = self._interior(b.data["pdf"])
            fluid = self._interior(b.data["mask"]) == CellType.FLUID
            # level-l cells have volume 8^-l of a root-cell unit
            total += float((interior.sum(axis=0) * fluid).sum()) * (8.0 ** -b.level)
        return total

    def max_velocity(self) -> float:
        self.materialize_host()
        vmax = 0.0
        for b in self.forest.all_blocks():
            _rho, u = macroscopic(b.data["pdf"], self.spec.lattice)
            fluid = b.data["mask"] == CellType.FLUID
            speed = np.sqrt((u**2).sum(axis=0)) * fluid
            vmax = max(vmax, float(self._interior(speed).max(initial=0.0)))
        return vmax

    def total_particles(self) -> int:
        """Tracer population across the whole forest (conservation probe)."""
        return _forest_total_particles(self.forest)

    def num_fluid_cells(self) -> int:
        return int(
            sum(
                (self._interior(b.data["mask"]) == CellType.FLUID).sum()
                for b in self.forest.all_blocks()
            )
        )
