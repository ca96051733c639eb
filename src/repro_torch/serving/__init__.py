"""Serving layer: many concurrent simulations on one shared pool.

Three pieces (see ARCHITECTURE.md "Serving layer"):

* :mod:`~repro.serving.ensemble` — batched ensemble execution: members
  sharing one forest topology advance under a single compiled superstep
  ``vmap``-ped over a leading member axis, with per-member physics as
  batched operands and divergence splits at AMR events.
* :mod:`~repro.serving.service` — the job driver: submit/poll/stream API,
  compatibility grouping, round-robin chunk scheduling, streamed
  diagnostics + registry-codec checkpoints, serving counters.
* :mod:`~repro.serving.elastic` — elastic ranks: mid-run rank-count resize
  via the in-memory checkpoint protocol, plus the straggler/shrink control
  plane ported from the seed training sketch.
"""

from .elastic import (
    ElasticPlan,
    ResizeReport,
    StragglerMonitor,
    greedy_assign_buckets,
    plan_shrink,
    resize_ranks,
)
from .ensemble import (
    Ensemble,
    EnsembleProgramCache,
    ensemble_compat_key,
    is_batchable,
    topology_key,
)
from .service import Job, JobSpec, SimulationService

__all__ = [
    "ElasticPlan",
    "Ensemble",
    "EnsembleProgramCache",
    "Job",
    "JobSpec",
    "ResizeReport",
    "SimulationService",
    "StragglerMonitor",
    "ensemble_compat_key",
    "greedy_assign_buckets",
    "is_batchable",
    "plan_shrink",
    "resize_ranks",
    "topology_key",
]
