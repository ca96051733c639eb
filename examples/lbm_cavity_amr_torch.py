"""End-to-end driver on the PyTorch port: 3D lid-driven cavity with dynamic
AMR (paper §5.1.1), the twin of ``examples/lbm_cavity_amr.py``.

Runs the LBM (D3Q19, TRT) with the velocity-gradient refinement criterion,
diffusion load balancing and per-level time stepping in any of the port's
six stepping modes: ``arena`` (persistent level buffers), ``fused`` (the
whole coarse step on the device), ``restack`` (per-substep restacking),
``sharded`` (rank-sharded host data plane with cross-rank halo messages),
``fused_sharded`` (per-rank device residency, messages routed by the host)
and ``device_sharded`` (one device per rank, payloads moved device to
device). Prints the same per-epoch diagnostics as the JAX example.

The device defaults to the card, and the run raises without one; pass
``--device cpu`` to run the plain PyTorch path on the host.
``device_sharded`` takes one device per rank: by default every visible
card once, so ``--nranks`` above the card count needs ``--rank-devices``,
e.g. ``--rank-devices cuda:0,cuda:0,cuda:0,cuda:0`` to put four ranks on
one card.

    PYTHONPATH=src python examples/lbm_cavity_amr_torch.py [--steps 12] [--mode arena]
    PYTHONPATH=src python examples/lbm_cavity_amr_torch.py --device cpu --mode device_sharded --nranks 4
"""

import argparse

from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig

MODES = ("arena", "fused", "sharded", "fused_sharded", "device_sharded", "restack")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--amr-interval", type=int, default=3)
    ap.add_argument("--mode", choices=MODES, default="arena")
    ap.add_argument("--nranks", type=int, default=8)
    ap.add_argument("--device", default=None, help="cpu, or a card (default: the card, raising without one)")
    ap.add_argument("--kernel-backend", choices=("cuda", "ref"), default="cuda")
    ap.add_argument(
        "--rank-devices",
        default=None,
        help="device_sharded: comma-separated device per rank, e.g. cuda:0,cuda:1",
    )
    args = ap.parse_args()

    cfg = LidDrivenCavityConfig(
        root_grid=(2, 2, 2),
        cells_per_block=(8, 8, 8),
        nranks=args.nranks,
        omega=1.6,
        u_lid=(0.08, 0.0, 0.0),
        collision="trt",
        max_level=2,
        refine_upper=0.04,
        refine_lower=0.006,
        balancer="diffusion-pushpull",
        stepping_mode=args.mode,
        device=args.device,
        kernel_backend=args.kernel_backend,
        rank_devices=None if args.rank_devices is None else tuple(args.rank_devices.split(",")),
    )
    sim = AMRLBM(cfg)
    print(f"initial: {sim.forest.num_blocks()} blocks "
          f"({sim.num_fluid_cells()} fluid cells), mass {sim.total_mass():.2f}, "
          f"stepping={args.mode}, device={sim.device}, backend={args.kernel_backend}")
    for _epoch in range(args.steps // args.amr_interval):
        sim.advance(args.amr_interval)
        report = sim.adapt()
        sim.forest.check_all()
        levels = {l: sim.forest.blocks_per_rank(l) for l in sim.forest.levels_in_use()}
        print(
            f"step {sim.coarse_step:3d}: blocks={sim.forest.num_blocks():4d} "
            f"levels={sorted(levels)} vmax={sim.max_velocity():.4f} "
            f"mass={sim.total_mass():.2f} amr={'ran' if report.executed else 'skipped'}"
        )
        for lvl, counts in levels.items():
            print(f"    L{lvl}: max/rank={max(counts)} total={sum(counts)}")
    halo = sim.data_stats["halo"]
    if halo.p2p_bytes:
        print(f"halo traffic: {halo.p2p_bytes} bytes in {halo.p2p_messages} "
              f"p2p messages over {halo.exchange_rounds} rounds")
    if args.mode == "fused":
        res = sim.arena.device()
        fused = sim.data_stats["fused"]
        print(f"fused: {fused.exchange_rounds} in-program exchanges, "
              f"{res.h2d_transfers} h2d / {res.d2h_transfers} d2h transfers "
              f"({res.h2d_bytes + res.d2h_bytes} bytes total)")
    if args.mode == "fused_sharded":
        fused = sim.data_stats["fused"]
        residencies = [a.device() for a in sim.arenas.per_rank if a.levels()]
        h2d = sum(r.h2d_transfers for r in residencies)
        d2h = sum(r.d2h_transfers for r in residencies)
        print(f"fused_sharded: {fused.p2p_bytes} device-message bytes in "
              f"{fused.p2p_messages} p2p messages over {fused.exchange_rounds} "
              f"rounds; {h2d} h2d / {d2h} d2h transfers across "
              f"{len(residencies)} ranks")
    if args.mode == "device_sharded":
        fused = sim.data_stats["fused"]
        held = sim.engine.device_held_bytes_per_rank()
        print(f"device_sharded: {fused.p2p_bytes} ppermute bytes in "
              f"{fused.p2p_messages} p2p messages over {fused.exchange_rounds} "
              f"in-program exchanges; {sim.comm.ppermute_rounds} ppermute "
              f"rounds, {sim.comm.ppermute_pad_bytes} pad bytes, "
              f"{held} held bytes/device on "
              f"{','.join(str(d) for d in sim.engine.rank_devices)}")
    print(f"done: {sim.amr_cycles} AMR cycles executed")


if __name__ == "__main__":
    main()
