"""The port's serving layer (``repro_torch.serving``), checkpoints and
resilience, on the conformance suite's ``BASE`` scenario (2^3 roots, 8^3
cells, ``max_level=1``, 8 coarse steps with AMR every 4) and its four
``MEMBERS`` of ``tests/test_serving.py``.

* On both backends the service batches the four ``arena`` jobs into one
  ensemble that splits once at the AMR event (the slow-lid member does not
  refine), with at most one program per (topology, level set) key. Every
  member equals the port's solo ``fused`` run of its config **bitwise**
  (forest, masks, whole pdf arrays): the ensemble runs the same kernels,
  through their member axis, on the same fill tables.
* Every member matches a solo run of the JAX package (``restack``,
  ``kernel_backend="ref"``): the same forest after each AMR event,
  interior density and velocity within the f32 kernel tolerance (rtol
  3e-5 / atol 3e-6: the frameworks sum moments in different orders), mass
  within 1e-6 relative.
* ``make_ensemble_superstep`` equals M solo ``make_fused_superstep`` calls
  bitwise, and the member routes of both kernel wrappers equal per-member
  calls, on CPU tensors.
* Elastic resize (in memory and through a disk checkpoint), the service's
  stream/poll/checkpoint and solo paths, the straggler and shrink planning,
  and the checkpoint/resilience protocol, as the JAX package's tests pin
  them.
"""

import numpy as np
import pytest
import torch
from torch_fill_cases import branch_fills, random_buffers, refined_forest

from repro.lbm import AMRLBM as JaxAMRLBM
from repro.lbm import LidDrivenCavityConfig as JaxConfig
from repro_torch.core import (
    AMRPipeline,
    BlockDataRegistry,
    Comm,
    DiffusionBalancer,
    ForestGeometry,
    make_uniform_forest,
)
from repro_torch.core.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core.resilience import ResilienceManager
from repro_torch.kernels.lbm_collide import ops
from repro_torch.kernels.lbm_collide.lbm_collide import (
    lbm_halo_fill,
    lbm_stream_collide,
    member_coeffs,
)
from repro_torch.lbm.criteria import macroscopic
from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
from repro_torch.lbm.halo import compile_ghost_plan
from repro_torch.lbm.lattice import D3Q19, D3Q27, omega_for_level
from repro_torch.particles import ParticlesConfig
from repro_torch.serving import (
    JobSpec,
    SimulationService,
    StragglerMonitor,
    is_batchable,
    plan_shrink,
    resize_ranks,
)

BASE = dict(
    root_grid=(2, 2, 2),
    cells_per_block=(8, 8, 8),
    omega=1.5,
    u_lid=(0.08, 0.0, 0.0),
    max_level=1,
    refine_upper=0.03,
    refine_lower=0.004,
)
COARSE_STEPS = 8
AMR_INTERVAL = 4
TOL = dict(rtol=3e-5, atol=3e-6)
# the four members of tests/test_serving.py; the last (omega=1.9, slow lid)
# never refines, so the batch splits at the AMR event
MEMBERS = [
    dict(omega=1.5, u_lid=(0.08, 0.0, 0.0)),
    dict(omega=1.7, u_lid=(0.06, 0.0, 0.0)),
    dict(omega=1.6, u_lid=(0.08, 0.02, 0.0)),
    dict(omega=1.9, u_lid=(0.05, 0.0, 0.0)),
]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The suite runs its files in parallel worker processes; one PyTorch
    intra-op thread a worker keeps the OpenMP pools of several workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**over) -> LidDrivenCavityConfig:
    return LidDrivenCavityConfig(**{**BASE, "device": "cpu", **over})


def _forest(sim) -> set:
    return {(b.bid, b.level, b.owner) for b in sim.forest.all_blocks()}


def _run(sim, steps=COARSE_STEPS) -> list[set]:
    """``sim.run`` unrolled, recording the forest after every AMR event."""
    forests = []
    for i in range(steps):
        sim.advance(1)
        if (i + 1) % AMR_INTERVAL == 0:
            sim.adapt()
            forests.append(_forest(sim))
    sim.materialize_host()
    return forests


def _assert_bitwise(sim, ref, *, interior_only: bool = False) -> None:
    sim.materialize_host()
    ref.materialize_host()
    assert {(b.bid, b.level) for b in sim.forest.all_blocks()} == {(b.bid, b.level) for b in ref.forest.all_blocks()}
    ref_blocks = {b.bid: b for b in ref.forest.all_blocks()}
    for b in sim.forest.all_blocks():
        rb = ref_blocks[b.bid]
        np.testing.assert_array_equal(b.data["mask"], rb.data["mask"])
        got, want = b.data["pdf"], rb.data["pdf"]
        if interior_only:
            got, want = sim.spec.interior(got), ref.spec.interior(want)
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def jax_members():
    """Each member's solo JAX ``restack`` run: (sim, forests after events)."""
    out = []
    for over in MEMBERS:
        sim = JaxAMRLBM(JaxConfig(stepping_mode="restack", kernel_backend="ref", **{**BASE, **over}))
        out.append((sim, _run(sim)))
    return out


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_service_batches_members_bitwise_as_solo_fused_and_near_jax(backend, jax_members):
    svc = SimulationService()
    ids = [
        svc.submit(JobSpec(config=_cfg(stepping_mode="arena", kernel_backend=backend, **over),
                           coarse_steps=COARSE_STEPS, amr_interval=AMR_INTERVAL))
        for over in MEMBERS
    ]
    assert svc.poll(ids[0])["status"] == "pending"
    svc.run()

    s = svc.summary()
    assert s["jobs_completed"] == len(MEMBERS)
    assert s["ensembles_formed"] == 1
    assert s["divergence_splits"] >= 1
    assert s["solo_steps"] == 0 and s["batched_steps"] == len(MEMBERS) * COARSE_STEPS
    # one program per (topology, level set): the uniform forest and the
    # refined one; the post-split group re-hits the cache
    assert s["compile_misses"] <= 2
    assert s["compile_hits"] >= 1
    stats = svc.data_stats["serving"]
    assert stats["compile"]["misses"] == s["compile_misses"]
    assert stats["stage"].seconds > 0

    amr_happened = False
    for jid, over, (jsim, jforests) in zip(ids, MEMBERS, jax_members):
        job = svc.jobs[jid]
        assert job.status == "done" and job.step == COARSE_STEPS
        rec = stats["jobs"][jid]
        assert rec["status"] == "done" and rec["steps_per_s"] > 0 and rec["latency_s"] > 0
        sim = job.sim
        amr_happened = amr_happened or sim.amr_cycles > 0

        solo = AMRLBM(_cfg(stepping_mode="fused", kernel_backend=backend, **over))
        assert _run(solo) == jforests, "the solo fused run grows the JAX forest at every AMR event"
        _assert_bitwise(sim, solo)  # whole arrays, ghost rings included

        jblocks = {b.bid: b for b in jsim.forest.all_blocks()}
        assert _forest(sim) == _forest(jsim)
        for b in sim.forest.all_blocks():
            rho, u = macroscopic(b.data["pdf"], sim.spec.lattice)
            rho_j, u_j = macroscopic(np.asarray(jblocks[b.bid].data["pdf"]), sim.spec.lattice)
            got = np.concatenate([sim.spec.interior(rho)[None], sim.spec.interior(u)])
            want = np.concatenate([sim.spec.interior(rho_j)[None], sim.spec.interior(u_j)])
            np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(sim.total_mass(), jsim.total_mass(), rtol=1e-6)
    assert amr_happened, "the run must cross an AMR event"


def _cavity_masks(arena) -> dict[int, np.ndarray]:
    """Walls, a lid and fluid on every level of a small forest."""
    masks = {}
    for l in arena.levels():
        m = np.zeros_like(arena.buffer(l, "mask"))
        m[:, 0] = 1
        m[:, :, :, -1] = 2
        masks[l] = m
    return masks


@pytest.mark.parametrize("backend", ["cuda", "ref"])
@pytest.mark.parametrize("collision", ["trt", "bgk"])
def test_ensemble_superstep_equals_solo_fused_supersteps_bitwise(backend, collision):
    """Three members on a three-level forest whose fills hold every segment
    kind: one ensemble coarse step equals each member's solo fused coarse
    step bit for bit, and launches what one solo step launches."""
    forest, reg, arena = refined_forest(cells=(4, 6, 4))
    levels = tuple(arena.levels())
    slots = {l: arena.slots(l) for l in levels}
    plans = {
        p: compile_ghost_plan(forest, reg, slots, fields=("pdf",), levels={l for l in levels if l >= levels[-1] - p})
        for p in range(levels[-1] + 1)
    }
    assert {k for fills in branch_fills(forest, reg, slots) for f in fills.values()
            for k in (s.kind for s in f.segments)} == {"same", "coarse", "fine"}
    masks = _cavity_masks(arena)
    physics = [(1.5, (0.08, 0.0, 0.0)), (1.7, (0.06, 0.01, 0.0)), (1.9, (0.05, 0.0, 0.02))]
    rng = np.random.default_rng(3)
    member_bufs = [random_buffers(rng, arena, D3Q19.Q, np.float32) for _ in physics]

    ens = ops.make_ensemble_superstep(levels=levels, plans=plans, masks=masks, lattice=D3Q19,
                                      collision=collision, backend=backend, device="cpu")
    coeffs = {
        l: member_coeffs([omega_for_level(o, l) for o, _u in physics], [u for _o, u in physics],
                         lattice=D3Q19, collision=collision, dtype=torch.float32)
        for l in levels
    }
    got = ens(tuple(torch.stack([b[i] for b in member_bufs]) for i in range(len(levels))), coeffs)

    for m, (omega, u_wall) in enumerate(physics):
        def kw(l):
            return dict(omega=omega_for_level(omega, l), lattice=D3Q19, u_wall=u_wall,
                        collision=collision, backend=backend)

        solo = ops.make_fused_superstep(
            levels=levels,
            plans=plans,
            steppers={l: ops.make_stream_collide(**kw(l)) for l in levels},
            masks={l: torch.as_tensor(masks[l]) for l in levels},
            halo_stepper_factory=lambda l, fill, idx: ops.make_halo_stream_collide(
                fill, idx, mask=masks[l], device="cpu", **kw(l)),
        )
        if m == 0:
            assert ens.fill_segments == solo.fill_segments
        want = solo(tuple(b.clone() for b in member_bufs[m]))
        for g, w in zip(got, want):
            torch.testing.assert_close(g[m], w, rtol=0, atol=0)
    assert ens.stencils == sum(
        len([l for l in levels if l >= levels[-1] - p]) for p in ops.substep_patterns(levels[-1])
    )


@pytest.mark.parametrize("lattice", [D3Q19, D3Q27], ids=["d3q19", "d3q27"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("collision", ["bgk", "trt"])
def test_member_routes_equal_per_member_calls_on_cpu(lattice, dtype, collision):
    """The member axis of both wrappers on CPU tensors: each member's slice
    equals a solo call with that member's coefficients, and nothing counts
    as a launch."""
    rng = np.random.default_rng(9)
    M, B, dims = 3, 4, (6, 5, 7)
    w = torch.as_tensor(lattice.w, dtype=dtype)[None, None, :, None, None, None]
    f = w * (1 + 0.05 * torch.as_tensor(rng.standard_normal((M, B, lattice.Q, *dims)), dtype=dtype))
    mask = torch.zeros((B, *dims), dtype=torch.int32)
    mask[:, 0], mask[:, -1], mask[:, :, 0] = 1, 2, 1
    physics = [(1.3, (0.05, 0.01, 0.0)), (1.6, (0.08, 0.0, 0.0)), (1.9, (0.0, 0.03, 0.01))]
    mc = member_coeffs([o for o, _ in physics], [u for _, u in physics], lattice=lattice,
                       collision=collision, dtype=dtype)
    assert tuple(mc.table.shape) == (M, lattice.Q + 2)
    n0, m0 = lbm_stream_collide.launches, lbm_stream_collide.member_launches
    got = lbm_stream_collide(f, mask, members=mc)
    for m, (omega, u_wall) in enumerate(physics):
        want = lbm_stream_collide(f[m].contiguous(), mask, omega=omega, u_wall=u_wall,
                                  lattice=lattice, collision=collision)
        torch.testing.assert_close(got[m], want, rtol=0, atol=0)
    assert (lbm_stream_collide.launches, lbm_stream_collide.member_launches) == (n0, m0)
    with pytest.raises(ValueError, match="member stack"):
        lbm_stream_collide(f[0], mask, members=mc)

    # the fill: every segment kind of a three-level forest, all members
    forest, reg, arena = refined_forest(cells=(6, 4, 8))
    index = {l: i for i, l in enumerate(arena.levels())}
    bufs = [torch.stack(s) for s in zip(*(random_buffers(rng, arena, lattice.Q, np.float64 if dtype == torch.float64
                                                         else np.float32) for _ in range(M)))]
    kinds = set()
    for fills in branch_fills(forest, reg, {l: arena.slots(l) for l in arena.levels()}):
        for l, fill in fills.items():
            for t in ops.fill_tables(fill, index, "cpu"):
                kinds.add(t.kind)
                args = (t.kind, t.dst_slot, t.dst_cell, t.src_slot, t.src_cell)
                dst = bufs[index[l]].clone()
                lbm_halo_fill(dst, dst if t.src == index[l] else bufs[t.src], *args)
                for m in range(M):
                    want = bufs[index[l]][m].clone()
                    lbm_halo_fill(want, want if t.src == index[l] else bufs[t.src][m], *args)
                    torch.testing.assert_close(dst[m], want, rtol=0, atol=0)
    assert kinds == {"same", "coarse", "fine"}


@pytest.mark.parametrize("mode", ["sharded", "fused_sharded"])
@pytest.mark.parametrize("nranks", [(4, 2), (2, 6)], ids=["4to2", "2to6"])
def test_elastic_resize_preserves_physics_bitwise(mode, nranks):
    """Resize mid-run (shrink 4->2 and grow 2->6) continues bitwise-
    identically to the fixed-rank reference."""
    n0, n1 = nranks
    ref = AMRLBM(_cfg(nranks=n0, stepping_mode=mode))
    ref.run(COARSE_STEPS, amr_interval=AMR_INTERVAL)

    sim = AMRLBM(_cfg(nranks=n0, stepping_mode=mode))
    sim.run(AMR_INTERVAL, amr_interval=AMR_INTERVAL)
    report = resize_ranks(sim, n1)
    assert report.old_nranks == n0 and report.new_nranks == n1
    assert sim.cfg.nranks == n1 and sim.comm.nranks == n1
    assert {b.owner for b in sim.forest.all_blocks()} <= set(range(n1))
    sim.run(COARSE_STEPS - AMR_INTERVAL, amr_interval=AMR_INTERVAL)
    _assert_bitwise(sim, ref, interior_only=True)


def test_elastic_resize_via_disk_checkpoint(tmp_path):
    """The durable variant routes the same protocol through the on-disk
    checkpoint files and stays bitwise too."""
    ref = AMRLBM(_cfg(nranks=2, stepping_mode="arena"))
    ref.run(6, amr_interval=AMR_INTERVAL)

    sim = AMRLBM(_cfg(nranks=2, stepping_mode="arena"))
    sim.run(4, amr_interval=AMR_INTERVAL)
    report = resize_ranks(sim, 3, checkpoint_dir=tmp_path / "ckpt")
    assert report.via_disk
    sim.run(2, amr_interval=AMR_INTERVAL)
    _assert_bitwise(sim, ref, interior_only=True)


def test_service_stream_poll_and_checkpoints(tmp_path):
    """The job driver streams diagnostics + registry-codec checkpoints in
    order and reports completion through poll()."""
    svc = SimulationService(checkpoint_root=tmp_path)
    jid = svc.submit(JobSpec(config=_cfg(stepping_mode="arena"), coarse_steps=COARSE_STEPS,
                             amr_interval=AMR_INTERVAL, checkpoint_every=4))
    events = list(svc.stream(jid))
    kinds = [e["type"] for e in events]
    assert kinds[-1] == "done"
    assert "diagnostics" in kinds and "checkpoint" in kinds
    diag_steps = [e["step"] for e in events if e["type"] == "diagnostics"]
    assert diag_steps == sorted(diag_steps)
    masses = [e["mass"] for e in events if e["type"] == "diagnostics"]
    np.testing.assert_allclose(masses, masses[0], rtol=1e-5)

    job = svc.jobs[jid]
    assert job.checkpoints, "checkpoint_every=4 must have streamed checkpoints"
    restored = load_checkpoint(job.checkpoints[-1], job.sim.registry, 2)
    assert restored.num_blocks() == job.sim.forest.num_blocks()
    polled = svc.poll(jid)
    assert polled["status"] == "done" and polled["step"] == COARSE_STEPS
    assert polled["checkpoints"] == len(job.checkpoints)


@pytest.mark.parametrize(
    "over",
    [dict(nranks=4, stepping_mode="sharded"),
     dict(stepping_mode="arena", particles=ParticlesConfig(per_block=4, seed=2))],
    ids=["sharded", "particles"],
)
def test_service_runs_unbatchable_jobs_solo_and_resizes(over):
    """Non-batchable configs (a sharded data plane, a job with tracers) run
    solo through their own engine, bitwise as a direct run; the service can
    elastically resize them mid-run."""
    cfg = _cfg(**over)
    assert not is_batchable(cfg)
    svc = SimulationService()
    jid = svc.submit(JobSpec(config=cfg, coarse_steps=6, amr_interval=AMR_INTERVAL))
    svc.run_round()  # advances the solo job by one amr_interval chunk
    assert svc.jobs[jid].step == AMR_INTERVAL
    report = svc.resize(jid, 2)
    assert report.new_nranks == 2
    svc.run()
    job = svc.jobs[jid]
    assert job.status == "done" and svc.counters["solo_steps"] == 6
    assert svc.summary()["compile_misses"] == 0, "solo jobs must not touch the batch cache"
    assert any(e["type"] == "resize" for e in job.events)

    ref = AMRLBM(_cfg(**over))
    ref.run(AMR_INTERVAL, amr_interval=AMR_INTERVAL)
    resize_ranks(ref, 2)
    ref.run(6 - AMR_INTERVAL, amr_interval=AMR_INTERVAL)
    _assert_bitwise(job.sim, ref)
    if "particles" in over:
        assert job.sim.total_particles() == ref.total_particles() > 0


def test_is_batchable_and_compat_key():
    """Either backend batches; members batch only with members of the same
    math on the same device."""
    assert is_batchable(_cfg(stepping_mode="arena"))
    assert is_batchable(_cfg(stepping_mode="fused", kernel_backend="ref"))
    assert not is_batchable(_cfg(stepping_mode="restack"))
    from repro_torch.serving import ensemble_compat_key

    a = ensemble_compat_key(_cfg(stepping_mode="arena", omega=1.9))
    assert a == ensemble_compat_key(_cfg(stepping_mode="fused", u_lid=(0.05, 0.0, 0.0)))
    assert a != ensemble_compat_key(_cfg(stepping_mode="arena", kernel_backend="ref"))
    assert a != ensemble_compat_key(_cfg(stepping_mode="arena", collision="bgk"))
    assert a != ensemble_compat_key(_cfg(stepping_mode="arena", device="meta"))


# -- the straggler and shrink planning (tests/test_elastic.py) -----------------


def test_straggler_monitor_shifts_load_away_from_slow_host():
    mon = StragglerMonitor(n_hosts=4)
    for _ in range(5):  # host 2 is 3x slower
        mon.observe(np.array([1.0, 1.0, 3.0, 1.0]))
    caps = mon.capacities()
    assert caps[2] < 0.5 and caps[0] > 0.9
    rng = np.random.default_rng(0)
    buckets = list(rng.pareto(1.5, 32) + 0.5)
    assign, _ = mon.rebalance_buckets(buckets)
    loads = np.zeros(4)
    for w, h in zip(buckets, assign):
        loads[h] += w
    assert loads[2] < sum(buckets) / 4


def test_plan_shrink_keeps_model_axis():
    rng = np.random.default_rng(1)
    buckets = list(rng.pareto(1.5, 24) + 0.5)
    plan = plan_shrink(
        alive_hosts=[0, 1, 3, 4, 6, 7],  # lost hosts 2 and 5
        chips_per_host=8,
        model_parallel=16,
        last_checkpoint_step=1000,
        bucket_tokens=buckets,
    )
    assert plan.mesh_shape == (3, 16)
    assert plan.resume_step == 1000
    assert len(plan.bucket_assignment) == 24
    assert set(plan.bucket_assignment) <= set(range(6))


# -- checkpoint/restart and resilience (tests/test_checkpoint_resilience.py) ---


@pytest.fixture
def geom():
    return ForestGeometry(root_grid=(2, 2, 1), max_level=8)


def _forest_with_payload(geom, nranks):
    forest = make_uniform_forest(geom, nranks, level=1)
    for b in forest.all_blocks():
        b.data["payload"] = np.full((3,), float(b.bid % 1000))
    return forest


def test_checkpoint_roundtrip_same_ranks(geom, tmp_path):
    reg = BlockDataRegistry.trivial()
    forest = _forest_with_payload(geom, 4)
    save_checkpoint(forest, reg, tmp_path)
    restored = load_checkpoint(tmp_path, reg, nranks=4)
    restored.check_all()
    assert restored.num_blocks() == forest.num_blocks()
    for b in restored.all_blocks():
        assert float(b.data["payload"][0]) == float(b.bid % 1000)


@pytest.mark.parametrize("new_ranks", [2, 7])
def test_checkpoint_restart_on_different_rank_count(geom, tmp_path, new_ranks):
    reg = BlockDataRegistry.trivial()
    forest = _forest_with_payload(geom, 4)
    save_checkpoint(forest, reg, tmp_path)
    restored = load_checkpoint(tmp_path, reg, nranks=new_ranks)
    restored.check_all()
    assert restored.num_blocks() == forest.num_blocks()
    counts = restored.blocks_per_rank()
    assert max(counts) - min(counts) <= max(2, forest.num_blocks() // new_ranks)


def test_resilience_restores_after_failures(geom):
    reg = BlockDataRegistry.trivial()
    forest = _forest_with_payload(geom, 8)
    n_blocks = forest.num_blocks()
    pipe = AMRPipeline(
        balancer=DiffusionBalancer(mode="pushpull", flow_iterations=5, max_main_iterations=20),
        registry=reg,
    )
    mgr = ResilienceManager(reg)
    mgr.snapshot(forest, Comm(8))
    restored, _comm = mgr.fail_and_restore(forest, failed={1, 2, 7}, pipeline=pipe)
    restored.check_all()
    assert restored.nranks == 5
    assert restored.num_blocks() == n_blocks
    for b in restored.all_blocks():
        assert float(b.data["payload"][0]) == float(b.bid % 1000)


def test_resilience_rejects_buddy_pair_failure(geom):
    reg = BlockDataRegistry.trivial()
    forest = _forest_with_payload(geom, 8)
    pipe = AMRPipeline(balancer=DiffusionBalancer(), registry=reg)
    mgr = ResilienceManager(reg)
    mgr.snapshot(forest, Comm(8))
    with pytest.raises(AssertionError, match="buddy pair"):
        mgr.fail_and_restore(forest, failed={2, 6}, pipeline=pipe)  # 6 = buddy of 2
