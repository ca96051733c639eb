"""Per-checker lint configuration of the port, scoped to ``src/repro_torch``.

The JAX package's :mod:`config` reads its scopes from ``pyproject.toml``'s
``[tool.repro_lint]`` tables, and every path there names ``src/repro``. The
port keeps its scopes here instead, in :data:`DEFAULTS`, and
:func:`load_config` never reads ``pyproject.toml``: the twin lints the
port's tree with the port's scopes whatever the reference's tables say.
What each table declares:

* ``host_transfer`` — the hot-path modules, where every device->host sync
  is either a bug or carries a ``host-ok`` annotation;
* ``collective`` — the stepping roots whose import closure must be free of
  collectives, the control-plane modules excluded from it, the collective
  names flagged on any callee and the ``torch.distributed`` functions
  flagged where the callee resolves to that module;
* ``retrace`` — the program factories the static scan watches and the
  program-build budgets the runtime :class:`~.retrace.RetraceSentinel` is
  held to;
* ``protocol`` — the rank counts of the topology sweep.

There is no ``donation`` table: the port donates no buffer (see
:mod:`.checkers`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["LintConfig", "load_config", "DEFAULTS"]


DEFAULTS: dict = {
    # every sanctioned site carries an annotation with its reason, so the
    # committed baseline is an empty list
    "baseline": "tools/repro_lint_torch_baseline.json",
    "host_transfer": {
        "paths": [
            "src/repro_torch/lbm/engines.py",
            "src/repro_torch/lbm/halo.py",
            "src/repro_torch/kernels/lbm_collide",
            "src/repro_torch/serving/ensemble.py",
            # imported by every hot-path module: its own code must stay free
            # of device->host syncs too
            "src/repro_torch/telemetry",
            # the LM serving path: a decode step makes no host sync (the
            # parameter converter, models/convert.py, is host code by design)
            "src/repro_torch/models/layers.py",
            "src/repro_torch/models/attention.py",
            "src/repro_torch/models/zoo.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/models/rwkv6.py",
            "src/repro_torch/models/mamba2.py",
            "src/repro_torch/train",
        ],
    },
    "collective": {
        "stepping_modules": [
            "repro_torch.lbm.engines",
            "repro_torch.lbm.halo",
            "repro_torch.kernels.lbm_collide.ops",
            "repro_torch.kernels.lbm_collide.lbm_collide",
            "repro_torch.kernels.lbm_collide.ref",
            "repro_torch.serving.ensemble",
        ],
        # control-plane modules: reachable through package imports but only
        # run from adapt()/AMR cycles, where collectives are sanctioned
        "exclude": [
            "repro_torch.core.balancing",
            "repro_torch.core.refine",
            "repro_torch.core.pipeline",
            "repro_torch.core.proxy",
            "repro_torch.core.migration",
            "repro_torch.core.checkpoint",
            "repro_torch.core.resilience",
        ],
        # flagged on any callee. ppermute stays listed, as in the reference:
        # DeviceComm.ppermute is the sanctioned p2p fabric, but every call
        # site must say so with '# repro: collective-ok(...)'
        "collectives": [
            "all_gather",
            "allgather",
            "all_gather_into_tensor",
            "all_reduce",
            "allreduce",
            "all_to_all",
            "alltoall",
            "all_to_all_single",
            "reduce_scatter",
            "reduce_scatter_tensor",
            "broadcast",
            "barrier",
            "ppermute",
        ],
        # flagged where the callee resolves to torch.distributed (these names
        # are too common to flag on any callee: Comm.send is the host p2p
        # fabric, torch.gather a tensor op)
        "distributed": [
            "send",
            "recv",
            "isend",
            "irecv",
            "batch_isend_irecv",
            "gather",
            "scatter",
            "reduce",
            "all_gather_object",
            "broadcast_object_list",
            "gather_object",
            "scatter_object_list",
            "monitored_barrier",
        ],
    },
    "retrace": {
        "paths": ["src/repro_torch"],
        # calls that build a stepping program: one inside a loop must sit in
        # a keyed cache's build (a 'build:*' span), never once a step
        "factories": [
            "make_fused_superstep",
            "make_device_superstep",
            "make_ensemble_superstep",
            "make_rank_absorb",
            "make_rank_absorb_split",
            "make_rank_emit",
            "_build_programs",
        ],
        # program builds (build:* spans) of the canonical scenario: BASE
        # physics (2^3 roots, 8^3 cells, max_level=1) at 4 ranks,
        # advance(2), adapt(force_rebalance=True), advance(2). Measured on
        # the CPU with kernel_backend="ref": fused 2 (build:fused_superstep),
        # fused_sharded 2 (build:rank_programs), device_sharded 2
        # (build:device_programs) -- one build per arena version, none per
        # step. The budgets are those counts.
        "budgets": {"fused": 2, "fused_sharded": 2, "device_sharded": 2},
    },
    "protocol": {
        # the 1/4/13-rank conformance topologies
        "ranks": [1, 4, 13],
    },
}


@dataclass
class LintConfig:
    repo_root: Path
    raw: dict = field(default_factory=dict)

    def section(self, name: str) -> dict:
        merged = dict(DEFAULTS.get(name, {}))
        merged.update(self.raw.get(name, {}))
        return merged

    @property
    def baseline_path(self) -> Path:
        return self.repo_root / self.raw.get("baseline", DEFAULTS["baseline"])


def load_config(repo_root: Path) -> LintConfig:
    """The port's configuration for ``repo_root``: :data:`DEFAULTS`, with
    nothing read from ``pyproject.toml`` (its tables scope the reference)."""
    return LintConfig(repo_root=Path(repo_root))
