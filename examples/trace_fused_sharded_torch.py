"""Generate the port's example telemetry trace, the twin of
``examples/trace_fused_sharded.py``: a 4-rank ``fused_sharded`` run whose
timeline shows the per-substep emit/interior/route/absorb phases, the AMR
pipeline stages around an AMR event, halo plan compiles, h2d/d2h residency
traffic, and per-pair p2p byte counters — everything
``tools/trace_report.py`` renders.

The 6x6x6 root grid matters: with 4 ranks, every rank then owns blocks with
no cross-rank face, so the interior/boundary split of the fused_sharded
substep actually engages. ``overlap_split=True`` forces the split on the
CPU too (on a card it is the default).

The device defaults to the card, and the run raises without one; pass
``--device cpu`` to run the plain PyTorch path on the host (the committed
trace is a CPU run).

    PYTHONPATH=src python examples/trace_fused_sharded_torch.py \
        [--out examples/traces/fused_sharded_4rank_torch.trace.json] [--device cpu]
    python tools/trace_report.py examples/traces/fused_sharded_4rank_torch.trace.json
"""

from __future__ import annotations

import argparse
from pathlib import Path

from repro_torch import telemetry
from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig


def main(argv: list[str] | None = None) -> Path:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="examples/traces/fused_sharded_4rank_torch.trace.json")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--device", default=None, help="cpu, or a card (default: the card, raising without one)")
    args = ap.parse_args(argv)

    telemetry.configure(enabled=True, capacity=8192)
    cfg = LidDrivenCavityConfig(
        root_grid=(6, 6, 6),
        cells_per_block=(4, 4, 4),
        nranks=4,
        max_level=1,
        stepping_mode="fused_sharded",
        overlap_split=True,  # see module docstring
        device=args.device,
    )
    sim = AMRLBM(cfg)
    sim.advance(args.steps // 2)
    sim.adapt(force_rebalance=True)  # the AMR event the timeline spans
    sim.advance(args.steps - args.steps // 2)

    path = telemetry.export.write_chrome_trace(args.out)
    tr = telemetry.get_tracer()
    phases = sorted({r.name for r in tr.records() if r.cat == "substep"})
    print(f"wrote {path} ({len(tr.records())} records, device={sim.device})")
    print(f"substep phases: {phases}")
    print(f"per-rank buffers: {tr.buffer_stats()}")
    return path


if __name__ == "__main__":
    main()
