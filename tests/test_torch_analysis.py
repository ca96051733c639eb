"""The port's static analyzer (``src/repro_torch/analysis``), mirroring
``tests/test_analysis.py``:

* fixture tests — each checker catches its seeded true positives in
  ``tests/fixtures/lint_torch/`` and stays silent on the sanctioned and
  benign cases beside them; an empty annotation reason is a finding;
* machinery — the hash-guarded baseline, and the program-build sentinel
  counting ``build:*`` spans while leaving telemetry exactly as it was;
* runtime budgets — ``fused``, ``fused_sharded`` and ``device_sharded`` on
  ``BASE`` at 4 ranks build one program per arena version, within the
  budgets of the port's config, and nothing in a warm ``advance``;
* protocol — the verifier proves the port's compiled plans (intact passes;
  a dropped message, a byte asymmetry and an out-of-bounds scatter are
  caught; the 1/4/13-rank sweep passes), and the plans the engines hold
  after an AMR event verify clean;
* the real tree — the port lints clean against its empty baseline, and
  the fixtures are never scanned.
"""

import dataclasses
import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis.protocol import verify_ghost_plan as jax_verify_ghost_plan
from repro.lbm.grid import LBMBlockSpec as JaxBlockSpec
from repro.lbm.grid import make_lbm_fields as jax_make_lbm_fields
from repro_torch import telemetry
from repro_torch.analysis import (
    DEFAULTS,
    Finding,
    LintConfig,
    RetraceSentinel,
    apply_baseline,
    budget_findings,
    build_sweep_topology,
    line_hash,
    load_baseline,
    load_config,
    rank_slot_map,
    run,
    sweep_topologies,
    verify_compiled_rank_plan,
    verify_ghost_plan,
    write_baseline,
)
from repro_torch.analysis.astutil import ModuleCache
from repro_torch.analysis.checkers import (
    annotation_findings,
    check_collective,
    check_host_transfer,
    check_retrace,
)
from repro_torch.analysis.engine_plans import one_owner_view, verify_engine_plans
from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig

REPO_ROOT = Path(__file__).resolve().parent.parent
FIXTURES = REPO_ROOT / "tests" / "fixtures" / "lint_torch"
BASE = dict(
    root_grid=(2, 2, 2),
    cells_per_block=(8, 8, 8),
    omega=1.5,
    u_lid=(0.08, 0.0, 0.0),
    max_level=1,
    refine_upper=0.03,
    refine_lower=0.004,
    kernel_backend="ref",
    device="cpu",
)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread, so that parallel test workers share the host."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _restore_global_tracer():
    """Tests mutate the process-wide tracer; restore the defaults so the
    rest of the suite keeps its zero-overhead disabled path."""
    yield
    telemetry.configure(enabled=False, clock=time.perf_counter)
    telemetry.get_tracer().reset()


def _lines(findings, path):
    return sorted(f.line for f in findings if f.path == path)


# -- fixture tests -----------------------------------------------------------------


def test_host_checker_catches_seeded_violations():
    cfg = LintConfig(repo_root=FIXTURES, raw={"host_transfer": {"paths": ["fixture_host.py"]}})
    findings = check_host_transfer(cfg, ModuleCache(FIXTURES))
    # .item() 10, .cpu().numpy() 14 (twice), .tolist() 18, .to("cpu") 22,
    # .to(device="cpu") 23, torch.cuda / port / Event synchronize 28-30,
    # np.asarray 34, casts of a Tensor parameter, a torch call and a name
    # bound to a tensor 38, 39, 41
    assert _lines(findings, "fixture_host.py") == [10, 14, 14, 18, 22, 23, 28, 29, 30, 34, 38, 39, 41]
    # the annotated copy (47), the literal argument (51), casts of numpy
    # lattice constants and a host enum (54, 55) and of tensor metadata
    # (56, 57) are the sanctioned shapes
    assert all(f.checker == "host" for f in findings)
    assert "tensor expression" in next(f for f in findings if f.line == 38).message


def test_collective_checker_uses_reachability_and_resolves_torch_distributed():
    root = FIXTURES / "collective_tree"
    cfg = LintConfig(
        repo_root=root,
        raw={"collective": {"stepping_modules": ["steppkg.stepping"], "exclude": ["steppkg.control"]}},
    )
    findings = check_collective(cfg, ModuleCache(root))
    # dist.all_reduce 10, dist.send 11, an unannotated ppermute 13,
    # torch.distributed.barrier 16; the host Comm.send (12), the annotated
    # ppermute (15) and torch.gather (17) stay clean
    assert _lines(findings, "src/steppkg/stepping.py") == [10, 11, 13, 16]
    # isend imported from torch.distributed, one import hop away; the fabric
    # implementing allreduce (11) and the excluded control plane stay clean
    assert _lines(findings, "src/steppkg/support.py") == [7]
    by_line = {(f.path, f.line): f.message for f in findings}
    assert "torch.distributed.send" in by_line["src/steppkg/stepping.py", 11]
    assert "steppkg.support <- steppkg.stepping" in by_line["src/steppkg/support.py", 7]
    assert len(findings) == 5


def test_retrace_checker_flags_builds_in_loops_outside_keyed_caches():
    cfg = LintConfig(repo_root=FIXTURES, raw={"retrace": {"paths": ["fixture_retrace.py"]}})
    findings = check_retrace(cfg, ModuleCache(FIXTURES))
    # a build a step in a for loop (12) and a build a rank in a
    # comprehension (18); builds under a 'build:*' span (23), inside a
    # factory composing sub-programs (27) and annotated (34) stay clean
    assert _lines(findings, "fixture_retrace.py") == [12, 18]
    assert "make_fused_superstep" in findings[0].message


def test_annotation_checker_rejects_empty_reasons():
    cfg = LintConfig(
        repo_root=FIXTURES,
        raw={"host_transfer": {"paths": ["fixture_annotation.py"]}, "retrace": {"paths": []}},
    )
    cache = ModuleCache(FIXTURES)
    ann = annotation_findings(cfg, cache)
    assert _lines(ann, "fixture_annotation.py") == [9]
    assert ann[0].checker == "annotation"
    # an empty-reason allowlist entry does NOT suppress the finding it covers
    assert _lines(check_host_transfer(cfg, cache), "fixture_annotation.py") == [10]


# -- baseline machinery ------------------------------------------------------------


def _finding_for(path: Path, rel: str, lineno: int) -> Finding:
    text = path.read_text().splitlines()[lineno - 1]
    return Finding(checker="host", severity="error", path=rel, line=lineno, message="seeded",
                   fix_hint="", line_hash=line_hash(text))


def test_baseline_suppresses_then_fails_loudly_on_edit(tmp_path):
    src = tmp_path / "mod.py"
    src.write_text("x = 1\ny = dev.item()\n")
    f = _finding_for(src, "mod.py", 2)
    bl_path = tmp_path / "baseline.json"
    write_baseline(bl_path, [f])
    baseline = load_baseline(bl_path)
    assert len(baseline) == 1

    new, suppressed, stale = apply_baseline([f], baseline, tmp_path)
    assert new == [] and len(suppressed) == 1 and stale == []

    # a line shift with identical content still matches
    src.write_text("x = 1\nz = 0\ny = dev.item()\n")
    new, suppressed, stale = apply_baseline([_finding_for(src, "mod.py", 3)], baseline, tmp_path)
    assert new == [] and stale == []

    # editing the flagged line invalidates the entry loudly
    src.write_text("x = 1\ny = dev.mean().item()\n")
    new, suppressed, stale = apply_baseline([_finding_for(src, "mod.py", 2)], baseline, tmp_path)
    assert len(new) == 1
    assert len(stale) == 1 and "STALE" in stale[0]

    # a fixed finding (line intact, checker silent) is the other stale flavour
    src.write_text("x = 1\ny = dev.item()\n")
    new, suppressed, stale = apply_baseline([], baseline, tmp_path)
    assert new == [] and len(stale) == 1 and "no longer fires" in stale[0]


# -- program-build sentinel --------------------------------------------------------


@pytest.mark.parametrize("enabled", [False, True])
def test_retrace_sentinel_counts_builds_and_leaves_telemetry_as_it_was(enabled):
    tr = telemetry.get_tracer()
    telemetry.configure(enabled=enabled, capacity=256)
    tr.reset()
    tr.instant("before", cat="test")
    records_before = [(r.name, r.cat) for r in tr.records()]
    with RetraceSentinel() as s:
        for version in range(3):
            with tr.span("build:fused_superstep", cat="compile", version=version):
                pass
        with tr.span("build:rank_programs", cat="compile"):
            pass
        with tr.span("build:not_a_build", cat="stage"), tr.span("emit", cat="substep"):
            pass
        with pytest.raises(KeyError), RetraceSentinel() as inner:
            with tr.span("build:device_programs", cat="compile"):
                raise KeyError("a failed build still counts, and the sentinel still unwinds")
    assert s.counts == {"build:fused_superstep": 3, "build:rank_programs": 1, "build:device_programs": 1}
    assert inner.counts == {"build:device_programs": 1} and s.total() == 5
    # the wrapper is gone and the tracer is configured as before
    assert "span" not in vars(tr) and tr.enabled is enabled and tr.capacity == 256
    names = [(r.name, r.cat) for r in tr.records()]
    if enabled:  # recorded as they would have been without the sentinel
        assert names[0] == ("before", "test") and len(names) == 1 + 7
    else:
        assert names == records_before == [] and tr.span("x") is telemetry.NULL_SPAN

    assert budget_findings("unit", s.counts, 5) == []
    over = budget_findings("unit", s.counts, 4)
    assert len(over) == 1 and "traced 5 times, budget is 4" in over[0].message


@pytest.mark.parametrize(
    "mode,span",
    [("fused", "build:fused_superstep"), ("fused_sharded", "build:rank_programs"),
     ("device_sharded", "build:device_programs")],
)
def test_engine_stays_within_program_build_budget(mode, span):
    """The canonical scenario: 2 coarse steps, one AMR event, 2 coarse
    steps, at 4 ranks. Builds scale with arena versions, never with steps."""
    budget = load_config(REPO_ROOT).section("retrace")["budgets"][mode]
    assert budget == DEFAULTS["retrace"]["budgets"][mode]
    with RetraceSentinel() as s:
        sim = AMRLBM(LidDrivenCavityConfig(nranks=4, stepping_mode=mode, **BASE))
        v0 = sim.engine.storage_version()
        sim.advance(2)
        report = sim.adapt(force_rebalance=True)
        assert report.executed
        sim.advance(2)
    versions = sim.engine.storage_version() - v0 + 1
    assert budget_findings(mode, s.counts, budget) == []
    assert s.counts == {span: versions}
    with RetraceSentinel() as warm:
        sim.advance(2)
    assert warm.total() == 0  # a warm advance builds nothing


# -- halo-protocol verifier on the port's plans --------------------------------------


@pytest.fixture(scope="module")
def four_rank_plan():
    from repro_torch.lbm.grid import LBMBlockSpec, make_lbm_fields
    from repro_torch.lbm.halo import compile_rank_halo_plan

    forest = build_sweep_topology(4)
    registry = make_lbm_fields(LBMBlockSpec(cells=(8, 8, 8), ghost=1))
    rank_slots = rank_slot_map(forest)
    plan = compile_rank_halo_plan(forest, registry, rank_slots, fields=("pdf", "mask"))
    return forest, registry, plan, rank_slots


def test_protocol_verifier_passes_intact_plan(four_rank_plan):
    forest, registry, plan, rank_slots = four_rank_plan
    assert plan.messages, "4-rank sweep topology must exchange halos"
    assert verify_compiled_rank_plan(forest, registry, plan, rank_slots) == []


def test_protocol_verifier_catches_dropped_message(four_rank_plan):
    forest, registry, plan, rank_slots = four_rank_plan
    tampered = dataclasses.replace(plan, messages=plan.messages[1:])
    findings = verify_compiled_rank_plan(forest, registry, tampered, rank_slots)
    assert any("orphan send" in f.message for f in findings)
    assert any("coverage" in f.message or "ghost" in f.message for f in findings)


def test_protocol_verifier_catches_byte_asymmetry(four_rank_plan):
    forest, registry, plan, rank_slots = four_rank_plan
    msgs = list(plan.messages)
    msgs[0] = dataclasses.replace(msgs[0], nbytes=msgs[0].nbytes + 8)
    findings = verify_compiled_rank_plan(forest, registry, dataclasses.replace(plan, messages=tuple(msgs)), rank_slots)
    assert any("byte asymmetry" in f.message for f in findings)


def test_protocol_verifier_catches_out_of_bounds_scatter(four_rank_plan):
    forest, registry, plan, rank_slots = four_rank_plan
    msgs = list(plan.messages)
    m = msgs[0]
    lvl, slot, cell, n = m.scatter[0]
    msgs[0] = dataclasses.replace(m, scatter=((lvl, slot, np.full_like(cell, 10**7), n),) + m.scatter[1:])
    findings = verify_compiled_rank_plan(forest, registry, dataclasses.replace(plan, messages=tuple(msgs)), rank_slots)
    assert any("cell ids outside" in f.message for f in findings)


def test_protocol_sweep_proves_1_4_13_rank_topologies():
    assert sweep_topologies(tuple(DEFAULTS["protocol"]["ranks"])) == []


@pytest.mark.parametrize("mode", ["fused", "fused_sharded"])
def test_plans_the_engines_hold_verify_clean_across_amr_events(mode):
    """The plans each engine steps with, verified at each AMR event with the
    engine's own slot maps."""
    sim = AMRLBM(LidDrivenCavityConfig(nranks=4, stepping_mode=mode, **BASE))
    assert verify_engine_plans(sim) == []  # the roots
    events = 0
    for i in range(8):
        sim.advance(1)
        if (i + 1) % 4 == 0 and sim.adapt().executed:
            events += 1
            assert verify_engine_plans(sim) == []
    assert events >= 1 and sim.forest.levels_in_use() == [0, 1]


def test_ghost_plan_verifier_folds_owners_as_the_reference_does():
    """``verify_ghost_plan`` keys expected targets by owner, then folds the
    owners, so on a 4-rank forest it reports the other owners' targets as
    extra writes, in the port's copy and the JAX package's alike; the
    one-owner view of the same topology verifies clean."""
    sim = AMRLBM(LidDrivenCavityConfig(nranks=4, stepping_mode="fused", **BASE))
    sim.advance(4)
    assert sim.adapt().executed
    sim.advance(1)
    slots, plans = sim.engine.held_plans
    # the JAX copy groups fields through its own registry class
    jax_fields = jax_make_lbm_fields(JaxBlockSpec(cells=BASE["cells_per_block"], ghost=1))
    assert len(plans) == 2
    for plan in plans.values():
        ours = verify_ghost_plan(sim.forest, sim.fields, plan, slots)
        theirs = jax_verify_ghost_plan(sim.forest, jax_fields, plan, slots)
        assert ours and [f.message for f in ours] == [f.message for f in theirs]
        assert all("(0 missing" in f.message for f in ours)
        assert verify_ghost_plan(one_owner_view(sim.forest), sim.fields, plan, slots) == []


# -- real tree -----------------------------------------------------------------------


def test_real_tree_is_clean_against_the_empty_baseline():
    cfg = load_config(REPO_ROOT)
    assert load_baseline(cfg.baseline_path) == []
    findings = run(cfg)
    new, suppressed, stale = apply_baseline(findings, [], REPO_ROOT)
    assert new == [], "new lint findings:\n" + "\n".join(
        f"  {f.path}:{f.line} [{f.checker}] {f.message}" for f in new
    )
    assert suppressed == [] and stale == []


def test_fixtures_are_never_scanned_by_the_real_tree_run():
    cfg = load_config(REPO_ROOT)
    cache = ModuleCache(REPO_ROOT)
    for section in ("host_transfer", "retrace"):
        paths = cache.files(cfg.section(section)["paths"])
        assert paths and not any("fixtures" in p.parts for p in paths), section
    assert all(p.is_relative_to(REPO_ROOT / "src" / "repro_torch") for p in cache.files(cfg.section("retrace")["paths"]))


def _lint_driver():
    spec = importlib.util.spec_from_file_location("repro_lint_torch", REPO_ROOT / "tools" / "repro_lint_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lint_driver_runs_the_source_checkers_and_explains_donation(capsys):
    lint = _lint_driver()
    assert lint.main(["--checker", "donation"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and "donates no buffer" in out[0]
    assert lint.main(["--checker", "host", "--checker", "collective", "--checker", "retrace"]) == 0
    assert "0 finding(s), 0 baselined, 0 stale" in capsys.readouterr().out
