"""The port's real device ranks (``stepping_mode="device_sharded"``) on the
conformance suite's ``BASE`` scenario (2^3 roots, 8^3 cells,
``max_level=1``, 8 coarse steps with AMR every 4), every rank on the CPU.

* At 1, 2, 4 and 13 ranks ``device_sharded`` equals the port's ``restack``
  and ``fused_sharded`` **bitwise**: the same forest (block ids, levels,
  owners) after each AMR event, the same interiors and mass. At 13 ranks
  the 8 roots leave ranks without blocks, whose stacks are all padding.
* It matches the JAX package's ``restack`` within the f32 kernel tolerance
  (rtol 3e-5 / atol 3e-6) with mass within 1e-6 relative, and at one rank
  the JAX package's own ``device_sharded`` (one XLA device) at the same
  tolerance.
* Traffic: its ``DeviceComm`` p2p bytes and messages over two steady
  coarse steps equal ``fused_sharded``'s ``Comm`` deltas on the same
  trajectory; no collective; every message goes to a neighbour rank; the
  rounds are partial permutations covering every message once.
* Table 1: the cycle with tracers stays collective-free; the bytes each
  rank's device holds are equal on every rank and do not grow from 2 to 4
  ranks.
* Padding: padded counts are the per-level maximum, no plan touches a pad
  slot, and stepping a padded stack leaves real slots bitwise the
  unpadded step's and pad slots unchanged (the port's ``ref`` stepper and
  the kernels' plain versions).
* Elastic resize 2 -> 4 keeps the ``DeviceComm`` and the physics; tracers
  match ``restack``'s within 1e-10; ``device=None`` without a card raises
  (the refusals of too few rank devices and of a plain ``Comm`` are in
  ``tests/test_torch_isolation.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch
from conftest import make_random_marks

from repro.lbm import AMRLBM as JaxAMRLBM
from repro.lbm import LidDrivenCavityConfig as JaxConfig
from repro_torch.core import (
    AMRPipeline,
    BlockDataRegistry,
    Comm,
    DeviceComm,
    DiffusionBalancer,
    ForestGeometry,
    make_uniform_forest,
)
from repro_torch.kernels.lbm_collide import ops
from repro_torch.lbm.criteria import macroscopic
from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
from repro_torch.lbm.engines import DeviceShardedEngine
from repro_torch.lbm.grid import CellType, LBMBlockSpec
from repro_torch.lbm.halo import (
    build_rank_halo_plan,
    compile_rank_halo_plan,
    padded_block_counts,
    schedule_ppermute_rounds,
    verify_padded_plan,
)
from repro_torch.lbm.lattice import D3Q19
from repro_torch.particles import ParticlesConfig, all_particles
from repro_torch.serving.elastic import resize_ranks

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
TRACERS = dict(per_block=24, seed=1, alpha=0.05, region=((0.0, 0.0, 1.7), (2.0, 2.0, 2.0)))


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The suite runs its files in parallel worker processes; one PyTorch
    intra-op thread a worker keeps the OpenMP pools of several workers from
    oversubscribing the cores (about 8x slower with the default pools)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _forest(sim) -> set:
    return {(b.bid, b.level, b.owner) for b in sim.forest.all_blocks()}


def _run(sim) -> list[set]:
    """``sim.run`` unrolled, recording the forest after every AMR event."""
    forests = []
    for i in range(COARSE_STEPS):
        sim.advance(1)
        if (i + 1) % AMR_INTERVAL == 0:
            sim.adapt()
            forests.append(_forest(sim))
    sim.materialize_host()
    return forests


def _torch(mode, nranks, kernel_backend="ref", **over):
    return AMRLBM(LidDrivenCavityConfig(
        nranks=nranks, stepping_mode=mode, device="cpu", kernel_backend=kernel_backend, **BASE, **over
    ))


def _assert_interiors_equal(sim, ref):
    want = {b.bid: b for b in ref.forest.all_blocks()}
    assert want.keys() == {b.bid for b in sim.forest.all_blocks()}
    for b in sim.forest.all_blocks():
        np.testing.assert_array_equal(
            sim.spec.interior(b.data["pdf"]), sim.spec.interior(want[b.bid].data["pdf"]), err_msg=hex(b.bid)
        )


def _assert_macroscopic_close(sim, ref):
    want = {b.bid: b for b in ref.forest.all_blocks()}
    sl = (slice(1, -1),) * 3
    for b in sim.forest.all_blocks():
        rho, u = macroscopic(b.data["pdf"], sim.spec.lattice)
        rho_r, u_r = macroscopic(want[b.bid].data["pdf"], sim.spec.lattice)
        np.testing.assert_allclose(rho[sl], rho_r[sl], **TOL)
        np.testing.assert_allclose(u[(Ellipsis, *sl)], u_r[(Ellipsis, *sl)], **TOL)
    m, m_ref = sim.total_mass(), ref.total_mass()
    assert abs(m - m_ref) / m_ref < 1e-6


@pytest.fixture(scope="module")
def runs():
    """Finished ``BASE`` runs, by (mode, nranks, backend), built once."""
    cache = {}

    def get(mode, nranks, backend="ref"):
        key = (mode, nranks, backend)
        if key not in cache:
            if mode.startswith("jax_"):
                sim = JaxAMRLBM(JaxConfig(nranks=nranks, stepping_mode=mode[4:], kernel_backend="ref", **BASE))
            else:
                sim = _torch(mode, nranks, kernel_backend=backend)
            cache[key] = (sim, _run(sim))
        return cache[key]

    return get


@pytest.mark.parametrize(
    "nranks, backend",
    [(1, "ref"), (2, "ref"), (4, "ref"), (13, "ref"), (4, "cuda")],
    ids=["1", "2", "4", "13", "cuda-4"],
)
def test_device_sharded_equals_restack_and_fused_sharded_bitwise(runs, nranks, backend):
    """``backend="cuda"`` runs the kernels' plain versions on CPU tensors:
    the same fills and stencils as on the card, through their wrappers."""
    sim, forests = runs("device_sharded", nranks, backend)
    assert sim.amr_cycles >= 1 and len(sim.forest.levels_in_use()) > 1
    assert isinstance(sim.comm, DeviceComm)
    assert sim.engine.rank_devices == (torch.device("cpu"),) * nranks
    for mode in ("restack", "fused_sharded"):
        ref, ref_forests = runs(mode, nranks, backend)
        assert forests == ref_forests, mode
        _assert_interiors_equal(sim, ref)
        assert sim.total_mass() == ref.total_mass()
    if nranks == 13:
        assert len({o for _b, _l, o in forests[-1]}) < 13, "some ranks hold no block"


@pytest.mark.parametrize("nranks", [2, 13])
def test_device_sharded_matches_jax_restack(runs, nranks):
    sim, forests = runs("device_sharded", nranks)
    ref, ref_forests = runs("jax_restack", nranks)
    assert forests == ref_forests
    _assert_macroscopic_close(sim, ref)


def test_device_sharded_matches_jax_device_sharded_at_one_rank(runs):
    sim, forests = runs("device_sharded", 1)
    ref, ref_forests = runs("jax_device_sharded", 1)
    assert forests == ref_forests
    _assert_macroscopic_close(sim, ref)
    g = sim.spec.ghost
    want = {b.bid: b for b in ref.forest.all_blocks()}
    for b in sim.forest.all_blocks():
        np.testing.assert_allclose(
            b.data["pdf"][(Ellipsis, *(slice(g, -g),) * 3)],
            want[b.bid].data["pdf"][(Ellipsis, *(slice(g, -g),) * 3)],
            **TOL,
        )


def _steady_deltas(mode):
    sim = _torch(mode, 4)
    sim.advance(2)
    sim.adapt()
    assert len(sim.forest.levels_in_use()) > 1
    sim.advance(1)  # programs rebuilt and stacks uploaded after the event
    before = sim.comm.stats.summary()
    moved = [(r.h2d_transfers, r.d2h_transfers) for r in sim.engine.residencies()]
    sim.advance(2)
    after = sim.comm.stats.summary()
    assert [(r.h2d_transfers, r.d2h_transfers) for r in sim.engine.residencies()] == moved
    keys = ("p2p_bytes", "p2p_messages", "allreduce_calls", "allgather_calls", "collective_bytes_per_rank")
    return sim, {k: after[k] - before[k] for k in keys}


def test_device_sharded_traffic_is_p2p_with_fused_sharded_parity():
    dev, ddelta = _steady_deltas("device_sharded")
    host, hdelta = _steady_deltas("fused_sharded")
    assert _forest(dev) == _forest(host)
    assert ddelta["allreduce_calls"] == ddelta["allgather_calls"] == 0
    assert ddelta["collective_bytes_per_rank"] == 0
    assert ddelta["p2p_bytes"] > 0
    assert ddelta["p2p_bytes"] == hdelta["p2p_bytes"]
    assert ddelta["p2p_messages"] == hdelta["p2p_messages"]

    arenas = dev.arenas
    rank_slots = {r: {l: arenas.per_rank[r].slots(l) for l in arenas.per_rank[r].levels()} for r in range(4)}
    plan = compile_rank_halo_plan(dev.forest, dev.fields, rank_slots)
    host_plan = build_rank_halo_plan(dev.forest, dev.fields)
    assert plan.cross_rank_bytes() == host_plan.cross_rank_bytes()
    for m in plan.messages:
        assert m.src_rank != m.dst_rank
        assert m.dst_rank in dev.forest.neighbor_ranks(m.src_rank)
        assert m.nbytes == host_plan.nbytes[(m.src_rank, m.dst_rank)]
    rounds = schedule_ppermute_rounds(plan.messages)
    covered = sorted(m.key for rnd in rounds for m in rnd.messages)
    assert covered == sorted(m.key for m in plan.messages)
    for rnd in rounds:
        srcs = [s for s, _ in rnd.perm]
        dsts = [d for _, d in rnd.perm]
        assert len(set(srcs)) == len(srcs) and len(set(dsts)) == len(dsts), rnd.perm
        assert rnd.num_cells == max(m.num_cells for m in rnd.messages)
    assert dev.comm.ppermute_rounds > 0
    assert dev.comm.ppermute_pad_bytes >= 0
    # one logical exchange a substep (2 coarse steps on the roots, then 3
    # with two levels), as the other fused engines count
    assert dev.data_stats["fused"].exchange_rounds == 2 * 1 + 1 * 2 + 2 * 2


def test_device_sharded_cycle_with_tracers_keeps_the_table1_shape():
    sim = _torch("device_sharded", 4, particles=ParticlesConfig(per_block=8, seed=1))
    sim.advance(2)
    before = sim.comm.stats.summary()
    sim.advance(2)
    after = sim.comm.stats.summary()
    assert after["allgather_calls"] == before["allgather_calls"] == 0
    assert after["allreduce_calls"] == before["allreduce_calls"]
    assert after["collective_bytes_per_rank"] == before["collective_bytes_per_rank"]
    assert after["p2p_bytes"] > before["p2p_bytes"]
    sim.adapt()
    assert sim.amr_cycles >= 1
    sim.advance(2)
    assert sim.comm.stats.allgather_calls == 0
    assert sim.data_stats["fused"].p2p_bytes > 0
    assert sim.data_stats["fused"].collective_bytes_per_rank == 0
    assert sim.data_stats["halo"].collective_bytes_per_rank == 0
    assert sim.total_particles() > 0 and sim.particles_advected > 0
    assert sim.data_stats["particles"].collective_bytes_per_rank == 0


def test_device_held_bytes_are_equal_per_rank_and_do_not_grow_with_ranks():
    def held(nranks):
        sim = _torch("device_sharded", nranks)
        sim.advance(2)
        sim.adapt()  # padding derived again for the refined forest
        sim.advance(2)
        sim.materialize_host()
        per_rank = sim.engine.device_held_bytes_by_rank()
        assert len(per_rank) == nranks and len(set(per_rank)) == 1, per_rank
        held = sim.engine.device_held_bytes_per_rank()
        assert type(held) is int and held == per_rank[0], (held, per_rank)
        # the padded pdf and mask stacks, each level at the largest rank's count
        progs = sim.engine._programs()
        cells = int(np.prod(sim.spec.mask_shape))
        assert held == sum(n * cells * (19 * 4 + 4) for n in progs.counts.values())
        return held

    h2, h4 = held(2), held(4)
    assert 0 < h4 <= h2, (h2, h4)


# -- equal-blocks-per-rank padding, on seeded random partitions ---------------

NRANKS = 4
SPEC = LBMBlockSpec(cells=(8, 8, 8), ghost=1, lattice=D3Q19)


def _random_partition(seed: int):
    geom = ForestGeometry(root_grid=(2, 2, 2), max_level=3)
    forest = make_uniform_forest(geom, NRANKS, level=1)
    pipe = AMRPipeline(
        balancer=DiffusionBalancer(mode="pushpull", flow_iterations=5),
        registry=BlockDataRegistry.trivial(),
    )
    forest, _report = pipe.run_cycle(forest, Comm(NRANKS), make_random_marks(seed))
    forest.check_all()
    return forest


def _rank_slots(forest):
    """Dense per-rank slot maps, as ``RankArenas.adopt`` assigns them."""
    slots = {}
    for r in range(NRANKS):
        per_level = {}
        for b in forest.local_blocks(r).values():
            per_level.setdefault(b.level, {})[b.bid] = len(per_level.get(b.level, {}))
        slots[r] = per_level
    return slots


@pytest.mark.parametrize("seed", range(3))
def test_padded_layout_and_plans_never_touch_a_padded_slot(seed):
    forest = _random_partition(seed)
    rank_slots = _rank_slots(forest)
    counts = padded_block_counts(rank_slots, NRANKS)
    for lvl in forest.levels_in_use():
        assert counts[lvl] == max(len(rank_slots[r].get(lvl, {})) for r in range(NRANKS))
    levels = sorted(forest.levels_in_use())
    lmax = levels[-1]
    for p in range(lmax + 1):
        plan = compile_rank_halo_plan(
            forest, SPEC, rank_slots, fields=("pdf",), levels={l for l in levels if l >= lmax - p}
        )
        assert verify_padded_plan(plan, rank_slots) == []
        covered = sorted(m.key for rnd in schedule_ppermute_rounds(plan.messages) for m in rnd.messages)
        assert covered == sorted(m.key for m in plan.messages)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("seed", range(3))
def test_padding_is_inert_under_the_stepper(seed, backend):
    """Stepping a padded stack equals stepping the real stack on its real
    slots, bitwise, and leaves the pad slots (weight pdfs under all-WALL
    masks) bitwise unchanged."""
    rng = np.random.default_rng(seed)
    Q = SPEC.lattice.Q
    shape = SPEC.mask_shape
    B, Bmax = 3, 5
    pdf = (0.1 + 0.9 * rng.random((B, Q) + shape)).astype(np.float32)
    mask = np.full((B,) + shape, CellType.WALL, np.int32)
    inner = (slice(None), slice(1, -1), slice(1, -1), slice(1, -1))
    mask[inner] = rng.choice(
        [CellType.FLUID, CellType.WALL, CellType.LID], size=mask[inner].shape, p=[0.8, 0.15, 0.05]
    ).astype(np.int32)
    w = np.asarray(SPEC.lattice.w, dtype=np.float32)
    pad_pdf = np.broadcast_to(w.reshape((Q, 1, 1, 1)), (Bmax - B, Q) + shape).copy()
    padded_pdf = torch.from_numpy(np.concatenate([pdf, pad_pdf]))
    padded_mask = torch.from_numpy(np.concatenate([mask, np.full((Bmax - B,) + shape, CellType.WALL, np.int32)]))
    step = ops.make_stream_collide(omega=1.5, lattice=SPEC.lattice, u_wall=(0.08, 0.0, 0.0),
                                   collision="trt", backend=backend)
    out_real = step(torch.from_numpy(pdf), torch.from_numpy(mask)).numpy()
    out_padded = step(padded_pdf, padded_mask).numpy()
    assert out_padded[:B].tobytes() == out_real.tobytes()
    assert out_padded[B:].tobytes() == pad_pdf.tobytes()


def test_engine_pads_every_rank_to_the_largest_count():
    """At 13 ranks some ranks own fewer blocks of a level than others (or
    none): their device stacks are padded with weight pdfs under all-WALL
    masks up to the largest rank's count."""
    n = 13
    sim = _torch("device_sharded", n)
    sim.advance(AMR_INTERVAL)
    sim.adapt()
    sim.advance(1)
    eng = sim.engine
    progs = eng._programs()
    lattice = sim.spec.lattice
    want = torch.as_tensor(lattice.w, dtype=torch.float32).reshape(1, lattice.Q, 1, 1, 1)
    for r in range(n):
        for l, pdf, mask in zip(progs.levels, eng._dev_pdfs[r], eng._dev_masks[r]):
            real = sim.arenas.num_blocks(r, l)
            assert pdf.shape[0] == mask.shape[0] == progs.counts[l] == max(
                sim.arenas.num_blocks(q, l) for q in range(n)
            )
            assert bool((mask[real:] == CellType.WALL).all())
            assert bool((pdf[real:] == want).all()), "pad slots keep the weight vector"
    assert any(progs.counts[l] > sim.arenas.num_blocks(r, l) for r in range(n) for l in progs.levels)


def test_padded_emit_ships_zero_rows_after_the_logical_payload():
    sim = _torch("device_sharded", 4)
    sim.advance(AMR_INTERVAL)
    sim.adapt()
    sim.advance(1)
    eng = sim.engine
    levels = eng._programs().levels
    index = {l: i for i, l in enumerate(levels)}
    per_rank = eng.arenas.per_rank
    rank_slots = {r: {l: per_rank[r].slots(l) for l in per_rank[r].levels()} for r in range(4)}
    plan = compile_rank_halo_plan(sim.forest, sim.fields, rank_slots, fields=("pdf",), levels=set(levels))
    padded = 0
    for rnd in schedule_ppermute_rounds(plan.messages):
        for m in rnd.messages:
            pdfs = eng._dev_pdfs[m.src_rank]
            (plain,) = ops.make_rank_emit([m], index, "cpu")(pdfs)
            (wire,) = ops.make_rank_emit([m], index, "cpu", rows=[rnd.num_cells])(pdfs)
            assert wire.shape == (rnd.num_cells, 19)
            torch.testing.assert_close(wire[: m.num_cells], plain, rtol=0, atol=0)
            assert not wire[m.num_cells:].any()
            padded += rnd.num_cells > m.num_cells
    assert padded > 0


# -- elastic resize, tracers, refusals ------------------------------------------


def test_device_sharded_resizes_from_two_to_four_ranks(runs):
    sim = _torch("device_sharded", 2)
    sim.advance(AMR_INTERVAL)
    sim.adapt()
    report = resize_ranks(sim, 4)
    assert report.new_nranks == 4 and sim.cfg.nranks == 4
    assert isinstance(sim.comm, DeviceComm), "resize keeps the fabric type"
    assert isinstance(sim.engine, DeviceShardedEngine) and len(sim.engine.rank_devices) == 4
    sim.advance(AMR_INTERVAL)
    sim.adapt()
    sim.materialize_host()
    ref, _ = runs("restack", 1)
    assert {(b.bid, b.level) for b in sim.forest.all_blocks()} == {(b.bid, b.level) for b in ref.forest.all_blocks()}
    _assert_interiors_equal(sim, ref)


def test_device_sharded_tracers_match_restack():
    def run(mode):
        sim = _torch(mode, 4, particles=ParticlesConfig(**TRACERS))
        n0 = sim.total_particles()
        forests = _run(sim)
        assert sim.total_particles() == n0 > 0
        return sim, forests

    (a, fa), (b, fb) = run("restack"), run("device_sharded")
    assert fa == fb
    pa, pb = all_particles(a.forest), all_particles(b.forest)
    np.testing.assert_array_equal(pa["id"], pb["id"])
    np.testing.assert_allclose(pb["pos"], pa["pos"], rtol=0, atol=1e-10)
    assert b.particles_moved > 0 or b.particles_advected > 0


def test_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LidDrivenCavityConfig(nranks=2, stepping_mode="device_sharded", **BASE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AMRLBM(dataclasses.replace(cfg, rank_devices=("cuda:0", "cuda:0")))
