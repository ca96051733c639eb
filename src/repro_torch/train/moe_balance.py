"""Diffusion-based MoE expert placement (the paper's technique on MoE archs).

Experts are blocks; the router's per-expert token counts are the block
weights; expert-parallel device groups are the ranks. Between training steps
the :class:`repro.core.DiffusionBalancer` recomputes the expert -> device
placement exactly like it rebalances AMR blocks: the *proxy* here is the
placement table (topology only, a few bytes per expert), and only once the
proxy is balanced are the actual expert weights migrated (one all-to-all of
the reassigned experts' parameters) — the same two-phase structure as the
paper's §2.3-§2.5.

For architectures whose expert count does not divide the model axis
(mixtral: 8e on 16-way TP), the placement is over virtual EP groups and the
balancer degenerates to the identity — documented in DESIGN.md.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .data import diffusion_assign_buckets

__all__ = ["ExpertPlacement"]


@dataclass
class ExpertPlacement:
    n_experts: int
    n_groups: int  # expert-parallel device groups
    # expert -> group assignment (current placement)
    assignment: list[int] = field(default_factory=list)
    history: list[dict] = field(default_factory=list)

    def __post_init__(self):
        if not self.assignment:
            per = self.n_experts // self.n_groups
            self.assignment = [min(e // max(per, 1), self.n_groups - 1) for e in range(self.n_experts)]

    def group_loads(self, expert_loads: np.ndarray) -> np.ndarray:
        loads = np.zeros(self.n_groups)
        for e, g in enumerate(self.assignment):
            loads[g] += float(expert_loads[e])
        return loads

    def rebalance(self, expert_loads: np.ndarray) -> tuple[list[int], int]:
        """One diffusion rebalance from measured router loads. Returns the
        list of migrated experts and the number of diffusion iterations."""
        before = self.group_loads(expert_loads)
        new_assign, iters = diffusion_assign_buckets(
            [float(w) for w in expert_loads], self.n_groups
        )
        moved = [e for e in range(self.n_experts) if new_assign[e] != self.assignment[e]]
        after_loads = np.zeros(self.n_groups)
        for e, g in enumerate(new_assign):
            after_loads[g] += float(expert_loads[e])
        self.history.append(
            {
                "max_before": float(before.max()),
                "max_after": float(after_loads.max()),
                "avg": float(expert_loads.sum() / self.n_groups),
                "moved": len(moved),
                "iters": iters,
            }
        )
        self.assignment = new_assign
        return moved, iters

    def permutation(self) -> np.ndarray:
        """Expert order such that each group's experts are contiguous — apply
        to stacked expert weights (gather) after rebalancing so the sharded
        expert dimension maps groups to devices."""
        order = sorted(range(self.n_experts), key=lambda e: (self.assignment[e], e))
        return np.asarray(order, dtype=np.int32)
