"""Fault tolerance demo (paper §4.2): buddy snapshots + shrink-restart.

A running AMR/LBM-style simulation takes periodic in-memory snapshots
(every rank backs up rank (X+N/2) mod N). We then kill 3 of 8 ranks and
show the simulation resuming on 5 ranks after one forced AMR cycle, with
all block payloads intact.

The twin of ``examples/resilience_demo.py`` on the PyTorch port: the
control plane and the codecs are host numpy, so there is no device to
pick; the disk checkpoint goes to a temporary directory.

    PYTHONPATH=src python examples/resilience_demo_torch.py
"""

import tempfile
from pathlib import Path

import numpy as np

from repro_torch.core import (
    AMRPipeline,
    Comm,
    DiffusionBalancer,
    FieldRegistry,
    FieldSpec,
    ForestGeometry,
    make_uniform_forest,
)
from repro_torch.core.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core.resilience import ResilienceManager


def main() -> None:
    geom = ForestGeometry(root_grid=(2, 2, 2), max_level=8)
    nranks = 8
    forest = make_uniform_forest(geom, nranks, level=1)

    # one typed declaration drives snapshot/restore AND disk checkpointing
    # (FieldRegistry derives the §2.5 callbacks; BlockDataRegistry.trivial()
    #  remains available for truly opaque payloads)
    reg = FieldRegistry(
        cells=(4, 4, 4),
        fields=(FieldSpec("payload", dtype=np.float32, refine="interpolate", coarsen="restrict"),),
    )
    rng = np.random.default_rng(0)
    for b in forest.all_blocks():
        arr = reg.alloc("payload")
        arr[...] = rng.standard_normal(arr.shape)
        b.data["payload"] = arr
    checksum = sum(float(b.data["payload"].sum()) for b in forest.all_blocks())

    pipe = AMRPipeline(
        balancer=DiffusionBalancer(mode="pushpull", flow_iterations=5, max_main_iterations=20),
        registry=reg,
    )
    comm = Comm(nranks)

    # --- in-memory buddy snapshot (no disk I/O) ------------------------------
    mgr = ResilienceManager(reg)
    mgr.snapshot(forest, comm)
    snap_bytes = sum(s.nbytes() for s in mgr.snapshots)
    print(f"snapshot taken: {forest.num_blocks()} blocks, "
          f"{snap_bytes / 1024:.0f} KiB redundant state, "
          f"p2p bytes {comm.stats.p2p_bytes}")

    # --- kill 3 ranks, restore + rebalance on 5 -------------------------------
    failed = {1, 2, 7}
    print(f"simulating failure of ranks {sorted(failed)} ...")
    restored, comm2 = mgr.fail_and_restore(forest, failed, pipe)
    restored.check_all()
    checksum2 = sum(float(b.data["payload"].sum()) for b in restored.all_blocks())
    print(f"restored on {restored.nranks} ranks: {restored.num_blocks()} blocks, "
          f"per-rank {restored.blocks_per_rank()}")
    print(f"payload checksum: {checksum:.4f} -> {checksum2:.4f} "
          f"({'OK' if abs(checksum - checksum2) < 1e-3 else 'MISMATCH'})")

    # --- disk checkpoint/restart on a different rank count (§4.1) -------------
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "repro_ckpt"
        save_checkpoint(restored, reg, ckpt)
        again = load_checkpoint(ckpt, reg, nranks=12)
    again.check_all()
    print(f"disk checkpoint reloaded onto 12 ranks: per-rank "
          f"{again.blocks_per_rank()}")


if __name__ == "__main__":
    main()
