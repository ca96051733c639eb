"""Static analysis of the port's own source and built exchange plans.

The twin of the JAX package's analyzer, scoped to ``src/repro_torch``:

* ``host`` — no implicit device->host syncs in hot-path modules
  (:func:`~repro_torch.analysis.checkers.check_host_transfer`);
* ``collective`` — the stepping path's import closure is collective-free
  (:func:`~repro_torch.analysis.checkers.check_collective`);
* ``protocol`` — compiled halo plans match pairwise, stay in bounds, and
  cover the ghost ring exactly (:mod:`repro_torch.analysis.protocol`, a
  whole copy of the reference's);
* ``retrace`` — program factories called in loops outside a keyed cache,
  plus the runtime :class:`~repro_torch.analysis.retrace.RetraceSentinel`
  program-build budget.

``donation`` has no counterpart: the port donates no buffer. Drive the
checkers via ``tools/repro_lint_torch.py`` or the functions re-exported
here.
"""

from .checkers import CHECKERS, run
from .config import DEFAULTS, LintConfig, load_config
from .findings import (
    Annotations,
    Finding,
    apply_baseline,
    line_hash,
    load_baseline,
    render,
    scan_annotations,
    write_baseline,
)
from .protocol import (
    build_sweep_topology,
    rank_slot_map,
    sweep_topologies,
    verify_compiled_rank_plan,
    verify_ghost_plan,
)
from .retrace import RetraceSentinel, budget_findings

__all__ = [
    "CHECKERS",
    "run",
    "DEFAULTS",
    "LintConfig",
    "load_config",
    "Annotations",
    "Finding",
    "apply_baseline",
    "line_hash",
    "load_baseline",
    "render",
    "scan_annotations",
    "write_baseline",
    "build_sweep_topology",
    "rank_slot_map",
    "sweep_topologies",
    "verify_compiled_rank_plan",
    "verify_ghost_plan",
    "RetraceSentinel",
    "budget_findings",
]
