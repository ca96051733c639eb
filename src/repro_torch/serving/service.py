"""Job driver: a submit/poll/stream service over batched ensembles.

:class:`SimulationService` is the bridge from "one big run" to "many
concurrent runs on a shared pool": callers submit scenario configs as
:class:`JobSpec`\\ s; the service groups compatible jobs into
:class:`~repro.serving.ensemble.Ensemble` batches (same compat key, same
forest topology, same AMR cadence), advances all groups round-robin in
``amr_interval``-sized chunks, runs each member's own AMR cycle at the
cadence boundaries (divergence splits regroup automatically), and streams
per-member diagnostics and registry-codec checkpoints back out.

Execution is cooperative and deterministic: :meth:`SimulationService.run`
(or iterating :meth:`stream`) drives rounds on the caller's thread — there
is no background concurrency, matching the repo's simulated-rank style.

Counters: ``data_stats["serving"]`` holds the data-plane wall time
(``stage``), per-job latency/throughput counters (``jobs``), and the shared
compile-cache statistics (``compile``) — the serving analogue of the
driver's per-stage ``data_stats``. :meth:`summary` flattens the same
numbers for the benchmark harness.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from pathlib import Path
from typing import TYPE_CHECKING, Iterator

from ..core.checkpoint import save_checkpoint
from ..core.pipeline import StageStats
from ..telemetry import get_tracer
from .elastic import ResizeReport, resize_ranks
from .ensemble import (
    Ensemble,
    EnsembleProgramCache,
    ensemble_compat_key,
    is_batchable,
    topology_key,
)

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..lbm.driver import AMRLBM, LidDrivenCavityConfig

__all__ = ["JobSpec", "Job", "SimulationService"]

_TR = get_tracer()


@dataclass(frozen=True)
class JobSpec:
    """One serving request: a scenario config plus run/streaming cadence."""

    config: "LidDrivenCavityConfig"
    coarse_steps: int
    amr_interval: int = 4
    checkpoint_every: int = 0  # coarse steps between streamed checkpoints (0 = off)
    collect_diagnostics: bool = True
    name: str = ""


@dataclass
class Job:
    """Live state of a submitted job (owned by the service)."""

    job_id: int
    spec: JobSpec
    sim: "AMRLBM"
    status: str = "pending"  # pending | running | done
    submitted_at: float = 0.0
    started_at: float | None = None
    finished_at: float | None = None
    events: list[dict] = dc_field(default_factory=list)
    checkpoints: list[str] = dc_field(default_factory=list)

    @property
    def step(self) -> int:
        return self.sim.coarse_step

    @property
    def remaining(self) -> int:
        return max(0, self.spec.coarse_steps - self.sim.coarse_step)


@dataclass
class _Group:
    """A scheduling unit: one ensemble batch or one solo job."""

    jobs: list[Job]
    ensemble: Ensemble | None  # None -> solo execution via the job's own engine


class SimulationService:
    """Group, batch, and round-robin many independent simulations.

    ``batching=False`` turns the grouping off (every job runs solo through
    its own stepping engine) — the sequential baseline the serving benchmark
    compares against.
    """

    def __init__(
        self,
        *,
        batching: bool = True,
        checkpoint_root: str | Path | None = None,
    ) -> None:
        self.batching = batching
        self.checkpoint_root = (
            Path(checkpoint_root) if checkpoint_root is not None else None
        )
        self.programs = EnsembleProgramCache()
        self.jobs: dict[int, Job] = {}
        self._next_id = 0
        self._pending: list[Job] = []
        self._groups: list[_Group] = []
        self.counters = {
            "jobs_submitted": 0,
            "jobs_completed": 0,
            "rounds": 0,
            "batched_steps": 0,  # member-coarse-steps advanced in ensembles
            "solo_steps": 0,
            "ensembles_formed": 0,  # groups formed with >= 2 members
            "divergence_splits": 0,  # extra groups created by AMR divergence
        }
        self.data_stats: dict[str, dict] = {
            "serving": {"stage": StageStats(), "jobs": {}, "compile": {}}
        }

    # -- submit / poll / stream ------------------------------------------------
    def submit(self, spec: JobSpec) -> int:
        """Accept a scenario config; returns the job id (grouping is lazy —
        compatible jobs submitted before the next round batch together)."""
        from ..lbm.driver import AMRLBM  # deferred: serving is importable alone

        job = Job(
            job_id=self._next_id,
            spec=spec,
            sim=AMRLBM(spec.config),
            submitted_at=_TR.clock(),
        )
        self._next_id += 1
        self.jobs[job.job_id] = job
        self._pending.append(job)
        self.counters["jobs_submitted"] += 1
        _TR.instant("job.submit", cat="serving", job=job.job_id)
        self._refresh_job_stats(job)
        return job.job_id

    def poll(self, job_id: int) -> dict:
        """Current status + latency/throughput counters for one job."""
        job = self.jobs[job_id]
        self._refresh_job_stats(job)
        return dict(self.data_stats["serving"]["jobs"][job_id])

    def stream(self, job_id: int) -> Iterator[dict]:
        """Yield a job's event records (diagnostics, checkpoints, resizes,
        completion) in order, driving service rounds from the consumer's
        loop until the job completes."""
        job = self.jobs[job_id]
        cursor = 0
        while True:
            while cursor < len(job.events):
                yield job.events[cursor]
                cursor += 1
            if job.status == "done":
                return
            progressed = self.run_round()
            if not progressed and cursor >= len(job.events):
                return  # nothing left to run and nothing new to drain

    def resize(self, job_id: int, new_nranks: int, **kw) -> ResizeReport:
        """Elastically resize a *solo* job's rank pool mid-run (batched
        members share one data plane — split or finish them first)."""
        job = self.jobs[job_id]
        for g in self._groups:
            if job in g.jobs:
                assert g.ensemble is None, "cannot resize a batched member"
        report = resize_ranks(job.sim, new_nranks, **kw)
        job.events.append(
            {
                "type": "resize",
                "step": job.step,
                "old_nranks": report.old_nranks,
                "new_nranks": report.new_nranks,
                "rebalanced": report.rebalanced,
            }
        )
        return report

    # -- scheduling ------------------------------------------------------------
    def _form_groups(self) -> None:
        """Drain pending jobs into scheduling groups: batchable jobs with the
        same (compat, topology, cadence) key share one ensemble."""
        if not self._pending:
            return
        batches: dict[tuple, list[Job]] = {}
        for job in self._pending:
            if self.batching and is_batchable(job.spec.config):
                key = (
                    ensemble_compat_key(job.spec.config),
                    topology_key(job.sim.forest),
                    job.spec.amr_interval,
                    job.step,  # lockstep cadence within a group
                )
                batches.setdefault(key, []).append(job)
            else:
                self._groups.append(_Group(jobs=[job], ensemble=None))
        for jobs in batches.values():
            ens = Ensemble([j.sim for j in jobs], programs=self.programs)
            self._groups.append(_Group(jobs=jobs, ensemble=ens))
            if len(jobs) >= 2:
                self.counters["ensembles_formed"] += 1
                _TR.instant(
                    "ensemble.form", cat="serving", members=len(jobs)
                )
        self._pending = []

    def run_round(self) -> bool:
        """Advance every active group by one ``amr_interval`` chunk (or to
        its members' finish line, whichever is nearer). Returns whether any
        work remains."""
        self._form_groups()
        if not self._groups:
            return False
        with _TR.stage("serving.round", cat="serving",
                       groups=len(self._groups)) as sp:
            next_groups: list[_Group] = []
            for g in self._groups:
                next_groups.extend(self._run_group_chunk(g))
        self._groups = next_groups
        self.counters["rounds"] += 1
        serving = self.data_stats["serving"]
        serving["stage"].add(StageStats(seconds=sp.seconds))
        serving["compile"] = {
            "hits": self.programs.hits,
            "misses": self.programs.misses,
            "hit_rate": self.programs.hit_rate(),
            "programs": len(self.programs),
        }
        return bool(self._groups or self._pending)

    def run(self) -> None:
        """Drive rounds until every submitted job completes."""
        while self.run_round():
            pass

    # -- internals -------------------------------------------------------------
    def _run_group_chunk(self, g: _Group) -> list[_Group]:
        now = _TR.clock()
        for j in g.jobs:
            if j.started_at is None:
                j.started_at = now
                j.status = "running"
        interval = g.jobs[0].spec.amr_interval
        chunk = min([interval] + [j.remaining for j in g.jobs])
        assert chunk >= 1, "finished jobs must leave their group"
        job_of_sim = {id(j.sim): j for j in g.jobs}

        if g.ensemble is not None:
            g.ensemble.advance(chunk)
            self.counters["batched_steps"] += chunk * len(g.jobs)
            at_boundary = g.jobs[0].step % interval == 0
            if at_boundary:
                parts = g.ensemble.adapt()  # materializes, may split
                if len(parts) > 1:
                    self.counters["divergence_splits"] += len(parts) - 1
                    _TR.instant(
                        "ensemble.split", cat="serving", parts=len(parts)
                    )
            else:
                g.ensemble.materialize()  # diagnostics/checkpoints read host
                parts = [g.ensemble]
            self.data_stats["serving"]["stage"].add(
                StageStats(exchange_rounds=g.ensemble.stats.exchange_rounds)
            )
            g.ensemble.stats = StageStats()  # consumed into the service stage
        else:
            job = g.jobs[0]
            job.sim.advance(chunk)
            self.counters["solo_steps"] += chunk
            if job.step % interval == 0:
                job.sim.adapt()
            parts = [None]

        for j in g.jobs:
            self._emit_events(j)
        finished = {id(j.sim) for j in g.jobs if j.remaining == 0}
        for j in g.jobs:
            if id(j.sim) in finished:
                self._finish(j)

        out: list[_Group] = []
        for part in parts:
            members = g.jobs if part is None else [
                job_of_sim[id(m)] for m in part.members
            ]
            alive = [j for j in members if id(j.sim) not in finished]
            if not alive:
                continue
            if part is None:
                out.append(_Group(jobs=alive, ensemble=None))
            elif len(alive) == len(part.members):
                out.append(_Group(jobs=alive, ensemble=part))
            else:  # membership shrank: rebatch survivors on the shared cache
                out.append(
                    _Group(
                        jobs=alive,
                        ensemble=Ensemble(
                            [j.sim for j in alive], programs=self.programs
                        ),
                    )
                )
        return out

    def _emit_events(self, job: Job) -> None:
        if job.spec.collect_diagnostics:
            job.events.append(
                {
                    "type": "diagnostics",
                    "step": job.step,
                    "mass": job.sim.total_mass(),
                    "max_velocity": job.sim.max_velocity(),
                    "amr_cycles": job.sim.amr_cycles,
                }
            )
        every = job.spec.checkpoint_every
        if every and self.checkpoint_root is not None and job.step % every == 0:
            path = self.checkpoint_root / f"job_{job.job_id:04d}" / (
                f"step_{job.step:06d}"
            )
            job.sim.materialize_host()
            save_checkpoint(job.sim.forest, job.sim.registry, path)
            job.checkpoints.append(str(path))
            job.events.append(
                {"type": "checkpoint", "step": job.step, "path": str(path)}
            )
        self._refresh_job_stats(job)

    def _finish(self, job: Job) -> None:
        job.status = "done"
        job.finished_at = _TR.clock()
        self.counters["jobs_completed"] += 1
        job.events.append({"type": "done", "step": job.step})
        _TR.instant("job.done", cat="serving", job=job.job_id, step=job.step)
        self._refresh_job_stats(job)

    def _refresh_job_stats(self, job: Job) -> None:
        now = job.finished_at if job.finished_at is not None else _TR.clock()
        run_s = (now - job.started_at) if job.started_at is not None else 0.0
        self.data_stats["serving"]["jobs"][job.job_id] = {
            "status": job.status,
            "step": job.step,
            "coarse_steps": job.spec.coarse_steps,
            "latency_s": now - job.submitted_at,
            "run_s": run_s,
            "steps_per_s": (job.step / run_s) if run_s > 0 else 0.0,
            "checkpoints": len(job.checkpoints),
        }

    def summary(self) -> dict:
        """Flat counter view for benchmarks and logs."""
        serving = self.data_stats["serving"]
        wall = serving["stage"].seconds
        done = self.counters["jobs_completed"]
        return {
            **self.counters,
            "wall_s": wall,
            "jobs_per_s": (done / wall) if wall > 0 else 0.0,
            "compile_hits": self.programs.hits,
            "compile_misses": self.programs.misses,
            "compile_cache_hit_rate": self.programs.hit_rate(),
            "programs": len(self.programs),
            "jobs": {k: dict(v) for k, v in serving["jobs"].items()},
        }
