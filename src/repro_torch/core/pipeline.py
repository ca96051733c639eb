"""The four-step AMR pipeline driver (paper Alg. 1, §2.1).

    1. mark blocks for refinement/coarsening + enforce 2:1   (refine.py)
    2. create the lightweight proxy data structure           (proxy.py)
    3. dynamically load balance the proxy                    (balancing/)
    4. migrate + refine/coarsen the actual simulation data   (migration.py)

The pipeline can be forced to run without any marks ("block weights must be
reevaluated and blocks must be redistributed"), supports multiple AMR cycles
per invocation, and records per-stage communication statistics so benchmarks
can attribute cost to stages exactly like the paper's Figures 8-13.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from ..telemetry import get_tracer
from .balancing.base import Balancer
from .comm import Comm
from .forest import Block, BlockForest
from .migration import BlockDataRegistry, migrate_data
from .proxy import ProxyWeightFn, build_proxy, migrate_proxy_blocks
from .refine import MarkCallback, mark_and_balance_targets

_TR = get_tracer()

__all__ = ["AMRPipeline", "CycleReport", "BlockWeightFn", "recompute_weights"]

# per-block weight callback evaluated on *actual* blocks (with their data):
# the paper's "block weights must be reevaluated" hook. Unlike ProxyWeightFn
# it sees the block's simulation payloads, so data-dependent load models
# (fluid-cell counts §3.2, particle counts) are expressible directly.
BlockWeightFn = Callable[[Block], float]


def recompute_weights(forest: BlockForest, weight_fn: BlockWeightFn) -> int:
    """Reevaluate every block's weight from its current data (process-local,
    no communication). Returns the number of blocks whose weight changed.

    The pipeline calls this automatically when ``block_weight_fn`` is set:
    once before each cycle (so the proxy is balanced against fresh loads) and
    once after data migration (so refined/coarsened/migrated blocks carry
    weights derived from their *actual* post-cycle data instead of whatever
    the proxy estimated — without this, new blocks keep their construction
    weight until the next reevaluation)."""
    changed = 0
    for b in forest.all_blocks():
        w = float(weight_fn(b))
        if w != b.weight:
            b.weight = w
            changed += 1
    return changed


@dataclass
class StageStats:
    seconds: float = 0.0
    p2p_bytes: int = 0
    p2p_messages: int = 0
    rounds: int = 0
    exchange_rounds: int = 0
    collective_bytes_per_rank: int = 0

    @staticmethod
    def delta(before: dict, after: dict, seconds: float) -> "StageStats":
        return StageStats(
            seconds=seconds,
            p2p_bytes=after["p2p_bytes"] - before["p2p_bytes"],
            p2p_messages=after["p2p_messages"] - before["p2p_messages"],
            rounds=after["rounds"] - before["rounds"],
            exchange_rounds=after.get("exchange_rounds", 0)
            - before.get("exchange_rounds", 0),
            collective_bytes_per_rank=after["collective_bytes_per_rank"]
            - before["collective_bytes_per_rank"],
        )

    def add(self, other: "StageStats") -> None:
        """Accumulate another stage observation (data-plane stages span many
        substeps; the driver folds each exchange's delta into one entry)."""
        self.seconds += other.seconds
        self.p2p_bytes += other.p2p_bytes
        self.p2p_messages += other.p2p_messages
        self.rounds += other.rounds
        self.exchange_rounds += other.exchange_rounds
        self.collective_bytes_per_rank += other.collective_bytes_per_rank


@dataclass
class CycleReport:
    executed: bool = False
    levels_changed: bool = False
    main_iterations: int = 0
    proxy_blocks_moved: int = 0
    stages: dict[str, StageStats] = field(default_factory=dict)

    def total_seconds(self) -> float:
        return sum(s.seconds for s in self.stages.values())


@dataclass
class AMRPipeline:
    balancer: Balancer
    registry: BlockDataRegistry
    weight_fn: ProxyWeightFn | None = None
    # data-dependent load model, reevaluated on the actual forest before each
    # balancing cycle and again after migration (see recompute_weights)
    block_weight_fn: BlockWeightFn | None = None

    def run_cycle(
        self,
        forest: BlockForest,
        comm: Comm,
        mark_fn: MarkCallback | None,
        *,
        force_rebalance: bool = False,
        max_cycles: int = 1,
    ) -> tuple[BlockForest, CycleReport]:
        """Run up to ``max_cycles`` AMR cycles (Alg. 1). Returns the new
        actual forest (the input forest is consumed) and a report."""
        report = CycleReport()
        current = forest
        for _cycle in range(max_cycles):
            # ---- step 0: reevaluate data-dependent block weights ------------
            # (later cycles are already covered by the post-migration call)
            if self.block_weight_fn is not None and _cycle == 0:
                recompute_weights(current, self.block_weight_fn)

            # ---- step 1: block-level refinement (+ 2:1) ---------------------
            s0 = comm.stats.summary()
            with _TR.stage("refine", cat="amr", cycle=_cycle) as sp:
                changed, ghost = mark_and_balance_targets(current, comm, mark_fn)
            report.stages["refine"] = StageStats.delta(
                s0, comm.stats.summary(), sp.seconds
            )
            report.levels_changed |= changed
            if not changed and not force_rebalance:
                # early exit: no marks and no forced weight reevaluation
                return current, report
            report.executed = True

            # ---- step 2: proxy data structure --------------------------------
            s0 = comm.stats.summary()
            with _TR.stage("proxy", cat="amr", cycle=_cycle) as sp:
                proxy = build_proxy(current, comm, ghost, self.weight_fn)
            report.stages["proxy"] = StageStats.delta(
                s0, comm.stats.summary(), sp.seconds
            )

            # ---- step 3: dynamic load balancing (iterative) -------------------
            s0 = comm.stats.summary()
            with _TR.stage("balance", cat="amr", cycle=_cycle) as sp:
                iteration = 0
                while True:
                    assignments, again = self.balancer(proxy, comm, iteration)
                    report.proxy_blocks_moved += migrate_proxy_blocks(
                        proxy, current, comm, assignments
                    )
                    iteration += 1
                    if not again:
                        break
                sp.set(iterations=iteration)
            report.main_iterations += iteration
            report.stages["balance"] = StageStats.delta(
                s0, comm.stats.summary(), sp.seconds
            )

            # ---- step 4: data migration + refine/coarsen ----------------------
            s0 = comm.stats.summary()
            with _TR.stage("migrate", cat="amr", cycle=_cycle) as sp:
                current = migrate_data(current, proxy, comm, self.registry)
            report.stages["migrate"] = StageStats.delta(
                s0, comm.stats.summary(), sp.seconds
            )
            # proxy is destroyed here (temporary structure, paper Fig. 6)
            del proxy
            # new blocks now hold their actual data: re-derive their weights
            # from the callback (split/merge proxy weights were estimates)
            if self.block_weight_fn is not None:
                recompute_weights(current, self.block_weight_fn)
            force_rebalance = False
            mark_fn = mark_fn if max_cycles > 1 else None
        return current, report
