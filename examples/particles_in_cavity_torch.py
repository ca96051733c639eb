"""Passive tracers in the lid-driven cavity vortex, on the PyTorch port: the
twin of ``examples/particles_in_cavity.py``.

Seeds Lagrangian tracers under the moving lid (where the flow is fastest),
advects them through the AMR-coupled LBM velocity field, and prints how the
tracer cloud spreads, how many hop blocks/ranks, and how the particle-aware
load model shifts weighted load across ranks.

The device defaults to the card, and the run raises without one; pass
``--device cpu`` to run the plain PyTorch path on the host.

    PYTHONPATH=src python examples/particles_in_cavity_torch.py --steps 12
    PYTHONPATH=src python examples/particles_in_cavity_torch.py --device cpu --mode sharded --nranks 4
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
from repro_torch.particles import ParticlesConfig, all_particles


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--mode", default="arena",
                    choices=["restack", "arena", "fused", "sharded",
                             "fused_sharded"])
    ap.add_argument("--nranks", type=int, default=4)
    ap.add_argument("--per-block", type=int, default=32)
    ap.add_argument("--device", default=None, help="cpu, or a card (default: the card, raising without one)")
    args = ap.parse_args()

    cfg = LidDrivenCavityConfig(
        root_grid=(2, 2, 2),
        cells_per_block=(8, 8, 8),
        nranks=args.nranks,
        omega=1.5,
        u_lid=(0.08, 0.0, 0.0),
        max_level=1,
        refine_upper=0.03,
        refine_lower=0.004,
        stepping_mode=args.mode,
        device=args.device,
        # seed the tracers into the developing lid vortex
        particles=ParticlesConfig(
            per_block=args.per_block,
            seed=1,
            alpha=0.05,
            region=((0.0, 0.0, 1.6), (2.0, 2.0, 2.0)),
        ),
    )
    sim = AMRLBM(cfg)
    n0 = sim.total_particles()
    print(f"seeded {n0} tracers under the lid "
          f"({args.mode} stepping, {args.nranks} simulated ranks, device={sim.device})")
    for i in range(args.steps):
        sim.advance(1)
        if (i + 1) % 4 == 0:
            sim.adapt()
        p = all_particles(sim.forest)
        com = p["pos"].mean(axis=0)
        spread = p["pos"].std(axis=0)
        vmax = float(np.abs(p["vel"]).max()) if len(p["id"]) else 0.0
        print(
            f"step {i + 1:3d}: com=({com[0]:.3f},{com[1]:.3f},{com[2]:.3f}) "
            f"spread=({spread[0]:.3f},{spread[1]:.3f},{spread[2]:.3f}) "
            f"max|v|={vmax:.4f} moved={sim.particles_moved} "
            f"blocks={sim.forest.num_blocks()}"
        )
    assert sim.total_particles() == n0, "tracer population must be conserved"
    loads = sim.forest.weights_per_rank()
    print("weighted load per rank:", [round(w, 1) for w in loads])
    st = sim.data_stats["particles"]
    print(
        f"particle stage: {st.seconds:.2f}s, advected {sim.particles_advected}, "
        f"cross-rank redistribution {st.p2p_bytes} bytes in {st.p2p_messages} messages"
    )


if __name__ == "__main__":
    main()
