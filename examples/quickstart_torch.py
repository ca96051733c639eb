"""Quickstart on the PyTorch port: the four-step AMR pipeline on a toy
forest, the twin of ``examples/quickstart.py``. The control plane is plain
numpy on the host, so there is no device to pick.

    PYTHONPATH=src python examples/quickstart_torch.py
"""

from repro_torch.core import (
    AMRPipeline,
    BlockDataRegistry,
    Comm,
    DiffusionBalancer,
    ForestGeometry,
    make_uniform_forest,
)

# a 2x2x2 root grid of octrees, distributed to 8 (simulated) ranks
geom = ForestGeometry(root_grid=(2, 2, 2), max_level=10)
forest = make_uniform_forest(geom, nranks=8, level=1)
for blk in forest.all_blocks():
    blk.data["payload"] = f"data-of-{blk.bid:#x}"  # blocks store arbitrary data

comm = Comm(nranks=8)
pipeline = AMRPipeline(
    balancer=DiffusionBalancer(mode="pushpull", flow_iterations=5, max_main_iterations=20),
    registry=BlockDataRegistry.trivial("payload"),
)


# mark callback: refine blocks touching the domain center, coarsen far corners
def mark(rank, blocks):
    out = {}
    center = (1 << geom.max_level), (1 << geom.max_level), (1 << geom.max_level)
    for bid, blk in blocks.items():
        x0, y0, z0, x1, y1, z1 = geom.aabb(bid)
        touches_center = x0 <= center[0] <= x1 and y0 <= center[1] <= y1 and z0 <= center[2] <= z1
        if touches_center and blk.level < 3:
            out[bid] = blk.level + 1
        elif not touches_center:
            out[bid] = blk.level - 1
    return out


print(f"before: {forest.num_blocks()} blocks, per-rank {forest.blocks_per_rank()}")
forest, report = pipeline.run_cycle(forest, comm, mark)
forest.check_all()  # leaf cover + adjacency + 2:1 balance
print(f"after:  {forest.num_blocks()} blocks, per-rank {forest.blocks_per_rank()}")
print(f"balance iterations: {report.main_iterations}, "
      f"proxy blocks moved: {report.proxy_blocks_moved}")
for stage, st in report.stages.items():
    print(f"  {stage:8s}: {st.seconds*1e3:7.1f} ms, {st.p2p_bytes:9d} p2p bytes, "
          f"{st.rounds} rounds")
print("comm totals:", comm.stats.summary())
