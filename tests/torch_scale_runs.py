"""One run of ``chip_smoke.py``'s phase 2e schedule at a cut shape on the
CPU, for ``tests/test_torch_sharded_scale.py``: importable by name, so that
a spawned process can run it beside the test's own runs."""

import importlib.util
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def scale_run(cut: dict, mode: str, framework: str) -> tuple[list, dict, dict | None]:
    """``AMRLBM`` of the port (``framework="torch"``, on the CPU, one
    intra-op thread) or of the JAX package (``"jax"``, plain versions) in
    ``mode``, through ``chip_smoke.scale_schedule``: (the forest after each
    event, bid -> the block's interior pdfs after the last step, and for the
    port ``chip_smoke.sim_digests``)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_scale_runs", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    if framework == "jax":
        from repro.lbm import AMRLBM, LidDrivenCavityConfig

        sim = AMRLBM(LidDrivenCavityConfig(stepping_mode=mode, kernel_backend="ref", **cut))
    else:
        import torch

        from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig

        torch.set_num_threads(1)
        sim = AMRLBM(LidDrivenCavityConfig(stepping_mode=mode, device="cpu", **cut))
    forests = chip_smoke.scale_schedule(sim)
    digests = chip_smoke.sim_digests(sim) if framework == "torch" else None
    sim.materialize_host()
    interiors = {b.bid: sim.spec.interior(np.asarray(b.data["pdf"])) for b in sim.forest.all_blocks()}
    return forests, interiors, digests
