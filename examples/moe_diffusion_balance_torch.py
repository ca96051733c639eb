"""The paper's technique applied to MoE serving, diffusion-balanced experts,
on the PyTorch port: the twin of ``examples/moe_diffusion_balance.py``
(host only: the placement is numpy), printing what it prints.

Experts are blocks, router token-counts are weights, expert-parallel device
groups are ranks (DESIGN.md §4). We simulate a skewed router (Zipf-like
expert popularity drifting over time) on the granite-moe-1b config (32
experts, top-8) across 16 EP groups, and rebalance the placement with the
same DiffusionBalancer that rebalances the AMR mesh — comparing against the
static (contiguous) placement a vanilla EP sharding uses.

    PYTHONPATH=src python examples/moe_diffusion_balance_torch.py
"""

import numpy as np

from repro_torch.configs import get_config
from repro_torch.train.moe_balance import ExpertPlacement


def router_loads(rng, n_experts: int, t: float) -> np.ndarray:
    """Zipf-ish expert popularity whose ranking drifts over time."""
    ranks = (np.arange(n_experts) + 7 * t) % n_experts
    base = 1.0 / (1.0 + ranks) ** 1.2
    noise = rng.lognormal(0.0, 0.25, n_experts)
    load = base * noise
    return load / load.sum() * 100_000  # tokens routed per window


def main() -> None:
    cfg = get_config("granite-moe-1b-a400m")
    E, groups = cfg.n_experts, 16
    rng = np.random.default_rng(0)
    static = ExpertPlacement(n_experts=E, n_groups=groups)
    dynamic = ExpertPlacement(n_experts=E, n_groups=groups)

    print(f"{cfg.arch_id}: {E} experts on {groups} EP groups "
          f"(static vs diffusion-rebalanced placement)\n")
    print(f"{'window':>6s} {'static max':>12s} {'dynamic max':>12s} "
          f"{'avg':>9s} {'moved':>6s} {'iters':>6s}")
    worst_static, worst_dyn = 0.0, 0.0
    for t in range(8):
        loads = router_loads(rng, E, t)
        s_max = static.group_loads(loads).max()
        moved, iters = dynamic.rebalance(loads)
        d_max = dynamic.group_loads(loads).max()
        avg = loads.sum() / groups
        worst_static = max(worst_static, s_max / avg)
        worst_dyn = max(worst_dyn, d_max / avg)
        print(f"{t:6d} {s_max:12.0f} {d_max:12.0f} {avg:9.0f} "
              f"{len(moved):6d} {iters:6d}")
    print(f"\npeak overload (max/avg): static {worst_static:.2f}x vs "
          f"diffusion {worst_dyn:.2f}x")
    print("expert->group permutation for the sharded weights:",
          dynamic.permutation()[:12], "...")


if __name__ == "__main__":
    main()
