"""Elastic ranks: resize a live simulation onto a different rank count.

The resize is the checkpoint/restart protocol run in memory (paper §4.1,
`core/checkpoint.py`): materialize host views, move-serialize every block
through the registry codec (:func:`~repro.core.checkpoint.snapshot_payloads`),
rebuild the forest onto the new rank count with the standard Morton
contiguous partition (:func:`~repro.core.checkpoint.rebuild_forest`), rebuild
the engine's per-rank storage (`RankArenas` re-adopt), and optionally run one
forced balance cycle with the simulation's own configured balancer so
ownership reflects the new pool. Pass ``checkpoint_dir`` to route the
snapshot through the on-disk files instead — the durable variant for
shrinking after a real capacity loss.

Bitwise contract: the codec round-trips every registered field — pdf
*including ghost layers* and the mask — unchanged, and the sharded data
planes are rank-count invariant (the same per-block kernel math and the same
exchange values regardless of which rank owns a block), so a resized run
continues bitwise-identically to a fixed-rank reference.

The control-plane half — deciding *when* and *how much* to resize — is the
straggler/shrink planning ported from the seed ``train/elastic.py`` sketch:
EWMA step-time monitoring per rank, capacity-weighted bucket reassignment,
and a shrink plan for surviving hosts. It is self-contained here (greedy LPT
assignment by default, any ``assign(weights, nranks)`` callable accepted,
e.g. ``repro.train.data.diffusion_assign_buckets``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import TYPE_CHECKING, Callable

import numpy as np

from ..core.checkpoint import (
    load_checkpoint,
    rebuild_forest,
    save_checkpoint,
    snapshot_payloads,
)
from ..telemetry import get_tracer

_TR = get_tracer()

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..lbm.driver import AMRLBM

__all__ = [
    "ElasticPlan",
    "ResizeReport",
    "StragglerMonitor",
    "greedy_assign_buckets",
    "plan_shrink",
    "resize_ranks",
]


# ---------------------------------------------------------------------------
# data-plane resize
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ResizeReport:
    """What a :func:`resize_ranks` call did."""

    old_nranks: int
    new_nranks: int
    nblocks: int
    via_disk: bool
    rebalanced: bool
    seconds: float


def resize_ranks(
    sim: "AMRLBM",
    new_nranks: int,
    *,
    rebalance: bool = True,
    checkpoint_dir: str | Path | None = None,
) -> ResizeReport:
    """Restore a live simulation onto ``new_nranks`` ranks mid-run.

    Composes the existing subsystems end to end: registry-codec snapshot →
    Morton redistribution onto the new rank count → fresh comm fabric and
    stepping engine → optional forced balance cycle with the simulation's
    configured balancer. Works for every stepping mode (the snapshot goes
    through materialized host views); physics continues bitwise-identically.

    With ``checkpoint_dir`` the snapshot round-trips through the on-disk
    checkpoint files (topology.json + per-rank payload pickles) instead of
    staying in memory — same protocol, durable variant.
    """
    from ..lbm.engines import make_engine  # local: avoid serving<->lbm cycle

    old_nranks = sim.cfg.nranks
    with _TR.stage("resize", cat="serving", old=old_nranks,
                   new=new_nranks) as sp:
        sim.materialize_host()  # codec reads host views
        if checkpoint_dir is not None:
            save_checkpoint(sim.forest, sim.registry, checkpoint_dir)
            forest = load_checkpoint(checkpoint_dir, sim.registry, new_nranks)
        else:
            entries = [
                {"bid": b.bid, "level": b.level, "weight": b.weight}
                for b in sim.forest.all_blocks()
            ]
            payloads = snapshot_payloads(sim.forest, sim.registry)
            forest = rebuild_forest(
                sim.geom, entries, payloads, sim.registry, new_nranks
            )
        sim.cfg = dataclasses.replace(sim.cfg, nranks=new_nranks)
        # preserve the fabric type (device_sharded runs on a DeviceComm)
        sim.comm = type(sim.comm)(new_nranks)
        sim.forest = forest
        # fresh engine: per-rank storage is sized by cfg.nranks at
        # construction, so rebuilding it is the rebind (mask travels through
        # the codec — no refresh needed, and the restored pdf ghosts stay
        # exactly as serialized)
        sim.engine = make_engine(sim)
        sim.engine.adopt(sim.forest)
        sim.engine.sync_caches()
        rebalanced = False
        if rebalance and new_nranks > 1:
            sim.forest, report = sim.pipeline.run_cycle(
                sim.forest, sim.comm, None, force_rebalance=True
            )
            if report.executed:
                rebalanced = True
                sim.engine.adopt(sim.forest)
                sim.engine.sync_caches()
    return ResizeReport(
        old_nranks=old_nranks,
        new_nranks=new_nranks,
        nblocks=len(list(sim.forest.all_blocks())),
        via_disk=checkpoint_dir is not None,
        rebalanced=rebalanced,
        seconds=sp.seconds,
    )


# ---------------------------------------------------------------------------
# control plane: straggler monitoring + shrink planning
# (ported from the seed train/elastic.py sketch; self-contained assignment)
# ---------------------------------------------------------------------------


def greedy_assign_buckets(
    bucket_weights: list[float], nranks: int
) -> tuple[list[int], int]:
    """LPT greedy: heaviest bucket to the least-loaded rank. Same contract as
    ``repro.train.data.diffusion_assign_buckets`` (assignment, iterations) so
    the two are interchangeable as ``assign`` callables."""
    n = len(bucket_weights)
    if n == 0:
        return [], 0
    order = sorted(range(n), key=lambda i: -bucket_weights[i])
    loads = np.zeros(max(1, nranks))
    assign = [0] * n
    for i in order:
        r = int(np.argmin(loads))
        assign[i] = r
        loads[r] += bucket_weights[i]
    return assign, 1


@dataclass
class StragglerMonitor:
    """EWMA step times per host; emits capacity weights for the balancer.

    Slow hosts are mitigated with the *same* machinery that balances AMR
    blocks: their measured throughput scales their share of the weighted
    buckets, realized by splitting each host into round(capacity*K) virtual
    ranks and running a standard bucket assignment over them.
    """

    n_hosts: int
    alpha: float = 0.2
    ewma: np.ndarray = field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        if self.ewma is None:
            self.ewma = np.zeros(self.n_hosts)

    def observe(self, step_times: np.ndarray) -> None:
        t = np.asarray(step_times, dtype=np.float64)
        self.ewma = np.where(
            self.ewma == 0, t, self.alpha * t + (1 - self.alpha) * self.ewma
        )

    def capacities(self) -> np.ndarray:
        """Relative per-host throughput (1.0 = median host)."""
        med = np.median(self.ewma[self.ewma > 0]) if (self.ewma > 0).any() else 1.0
        caps = np.where(self.ewma > 0, med / np.maximum(self.ewma, 1e-9), 1.0)
        return np.clip(caps, 0.1, 2.0)

    def rebalance_buckets(
        self,
        bucket_weights: list[float],
        *,
        assign: Callable[[list[float], int], tuple[list[int], int]] | None = None,
    ) -> tuple[list[int], int]:
        """Assign buckets ~proportionally to measured capacity: slow hosts
        present as fewer virtual ranks, so the assignment hands them less."""
        K = 4
        assign = assign or greedy_assign_buckets
        caps = self.capacities()
        virt_of_host = [max(1, int(round(c * K))) for c in caps]
        n_virt = sum(virt_of_host)
        assign_v, iters = assign(bucket_weights, n_virt)
        host_of_virt = []
        for h, nv in enumerate(virt_of_host):
            host_of_virt.extend([h] * nv)
        return [host_of_virt[v] for v in assign_v], iters


@dataclass(frozen=True)
class ElasticPlan:
    new_hosts: list[int]  # surviving host ids
    mesh_shape: tuple[int, ...]  # new (data, model) shape
    resume_step: int
    bucket_assignment: list[int]


def plan_shrink(
    *,
    alive_hosts: list[int],
    chips_per_host: int,
    model_parallel: int,
    last_checkpoint_step: int,
    bucket_tokens: list[float],
    assign: Callable[[list[float], int], tuple[list[int], int]] | None = None,
) -> ElasticPlan:
    """Plan resumption after losing hosts: keep the model axis intact (TP
    groups must not straddle dead hosts) and shrink the data axis; data
    buckets are rebalanced over the survivors."""
    assign = assign or greedy_assign_buckets
    total_chips = len(alive_hosts) * chips_per_host
    assert total_chips % model_parallel == 0, (
        f"{total_chips} chips cannot keep model_parallel={model_parallel}"
    )
    data = total_chips // model_parallel
    assignment, _ = assign(bucket_tokens, len(alive_hosts))
    return ElasticPlan(
        new_hosts=sorted(alive_hosts),
        mesh_shape=(data, model_parallel),
        resume_step=last_checkpoint_step,
        bucket_assignment=assignment,
    )
