"""The port's telemetry legs, mirroring ``tests/test_telemetry.py``'s
spans-equal-stats and Chrome-trace checks on ``repro_torch`` (the
telemetry package itself is a whole copy of the JAX package's):

* the recorded ``stage`` spans sum exactly to ``data_stats["halo"/"step"]``,
  and an AMR cycle's report equals its ``amr`` spans;
* an injected clock threads through the port's serving layer;
* a traced 4-rank ``fused_sharded`` run across an AMR event exports a
  Chrome trace that ``tools/trace_report.py`` accepts, with all four
  substep phases; so does the committed port trace;
* for one ``fused_sharded`` run of ``BASE`` across one AMR event, the port
  and the JAX package open the same spans, with equal counts by name.

Runs on the CPU with ``kernel_backend="ref"``.
"""

import json
import sys
import time
from collections import Counter
from pathlib import Path

import pytest
import torch

from repro import telemetry as jax_telemetry
from repro.lbm.driver import AMRLBM as JaxAMRLBM
from repro.lbm.driver import LidDrivenCavityConfig as JaxConfig
from repro_torch import telemetry
from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

from trace_report import PHASES, check_trace  # noqa: E402

BASE = dict(
    root_grid=(2, 2, 2),
    cells_per_block=(8, 8, 8),
    omega=1.5,
    u_lid=(0.08, 0.0, 0.0),
    max_level=1,
    refine_upper=0.03,
    refine_lower=0.004,
    kernel_backend="ref",
)


def _cfg(**over) -> LidDrivenCavityConfig:
    return LidDrivenCavityConfig(**{**BASE, "device": "cpu", **over})


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread, so that parallel test workers share the host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _restore_global_tracer():
    """Tests mutate the process-wide tracers; restore the defaults so the
    rest of the suite keeps its zero-overhead disabled path."""
    yield
    for tel in (telemetry, jax_telemetry):
        tel.configure(enabled=False, clock=time.perf_counter)
        tel.get_tracer().reset()


def _fake_clock(step: float = 1.0):
    t = [0.0]

    def clock() -> float:
        t[0] += step
        return t[0]

    return clock


# ---------------------------------------------------------------------------
# spans == stats
# ---------------------------------------------------------------------------


def test_stage_spans_equal_data_stats_exactly():
    telemetry.configure(enabled=True, capacity=8192)
    tr = telemetry.get_tracer()
    tr.reset()
    sim = AMRLBM(_cfg(stepping_mode="arena", nranks=2))
    sim.run(4, amr_interval=2)
    sums = telemetry.export.stage_seconds(tr, cat="stage")
    assert sums["halo"] == sim.data_stats["halo"].seconds
    assert sums["step"] == sim.data_stats["step"].seconds


def test_amr_cycle_report_matches_spans_exactly():
    telemetry.configure(enabled=True, capacity=8192)
    tr = telemetry.get_tracer()
    sim = AMRLBM(_cfg(stepping_mode="arena", nranks=2))
    sim.advance(2)
    tr.reset()  # isolate exactly one AMR cycle
    report = sim.adapt(force_rebalance=True)
    assert report.executed
    sums = telemetry.export.stage_seconds(tr, cat="amr")
    for stage in ("refine", "proxy", "balance", "migrate"):
        assert sums[stage] == report.stages[stage].seconds


def test_injectable_clock_threads_through_serving():
    from repro_torch.serving import JobSpec, SimulationService

    telemetry.configure(enabled=True, clock=_fake_clock())
    svc = SimulationService()
    jid = svc.submit(JobSpec(config=_cfg(stepping_mode="arena"), coarse_steps=2, amr_interval=4))
    svc.run()
    job = svc.jobs[jid]
    assert job.status == "done"
    latency = svc.data_stats["serving"]["jobs"][jid]["latency_s"]
    assert latency == job.finished_at - job.submitted_at
    assert latency == int(latency) and latency > 0  # whole fake-clock ticks


# ---------------------------------------------------------------------------
# Chrome-trace export
# ---------------------------------------------------------------------------


def test_fused_sharded_trace_is_valid_and_shows_all_phases(tmp_path):
    """The 6x6x6 grid gives every rank interior blocks at 4 ranks, so the
    overlap split engages and ``interior`` spans appear."""
    telemetry.configure(enabled=True, capacity=8192)
    tr = telemetry.get_tracer()
    tr.reset()
    sim = AMRLBM(_cfg(root_grid=(6, 6, 6), cells_per_block=(4, 4, 4), nranks=4,
                      stepping_mode="fused_sharded", overlap_split=True))
    sim.advance(1)
    assert sim.adapt(force_rebalance=True).executed, "the trace must span an AMR event"
    sim.advance(1)

    path = telemetry.export.write_chrome_trace(tmp_path / "t.json")
    trace = json.loads(path.read_text())
    assert check_trace(trace, require_substep_phases=True) == []
    names = {ev["name"] for ev in trace["traceEvents"] if ev.get("cat") == "substep"}
    assert set(PHASES) <= names
    assert any(ev["name"] == "amr.event" and ev["ph"] == "i" for ev in trace["traceEvents"])
    kinds = {ev["name"] for ev in trace["traceEvents"] if ev["ph"] == "C"}
    assert "substep.bytes" in kinds and "compiles" in kinds
    p2p = trace["metadata"]["metrics"]["comm.p2p_bytes"]["series"]
    assert p2p and all(v > 0 for v in p2p.values())
    for stats in trace["metadata"]["buffers"].values():
        assert stats["entries"] <= stats["capacity"] == 8192


def test_committed_port_trace_is_valid():
    path = ROOT / "examples" / "traces" / "fused_sharded_4rank_torch.trace.json"
    trace = json.loads(path.read_text())
    assert check_trace(trace, require_substep_phases=True) == []
    names = {ev["name"] for ev in trace["traceEvents"] if ev.get("cat") == "substep"}
    assert set(PHASES) <= names


# ---------------------------------------------------------------------------
# the port's spans against the JAX package's
# ---------------------------------------------------------------------------


def _span_counts(tel, amrlbm, config, **extra) -> Counter:
    tel.configure(enabled=True, capacity=65536)
    tr = tel.get_tracer()
    tr.reset()
    sim = amrlbm(config(nranks=4, stepping_mode="fused_sharded", overlap_split=True, **BASE, **extra))
    sim.advance(2)
    assert sim.adapt(force_rebalance=True).executed
    sim.advance(2)
    assert all(s["evicted"] == 0 for s in tr.buffer_stats().values())
    return Counter((r.cat, r.name) for r in tr.records() if r.ph == "X")


def test_port_opens_the_reference_spans_with_equal_counts():
    """Both packages open the same spans along ``fused_sharded``'s advance,
    the AMR cycle and the plan builds; instants and seconds differ by
    design (the port records no jit traces) and are not compared. The rank
    plans' spans differ by design too: the port compiles the whole forest's
    plan once an arena version (``compile_rank_forest_plan``,
    ``lbm/plans.py``), for its post-event host fill and every pattern's
    program, where the reference compiles each pattern's plan at each
    program build (1 pattern before the event, 2 after) and builds its
    region-list plan for the host fill."""
    ours = _span_counts(telemetry, AMRLBM, LidDrivenCavityConfig, device="cpu")
    theirs = _span_counts(jax_telemetry, JaxAMRLBM, JaxConfig)
    assert ours[("substep", "interior")] > 0 and ours[("compile", "build:rank_programs")] == 2
    assert ours.pop(("halo.plan", "compile_rank_forest_plan")) == ours[("compile", "build:rank_programs")]
    assert theirs.pop(("halo.plan", "compile_rank_halo_plan")) == 3
    assert theirs.pop(("halo.plan", "build_rank_halo_plan")) == 1
    assert ours == theirs
