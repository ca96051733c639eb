"""The real device ranks at the card's scale (``chip_smoke.py``'s phase 2e),
held here on the CPU at a cut size.

Phase 2e runs phase 2d's schedule (``scale_schedule``: 11 coarse steps,
AMR after steps 4 and 8) in ``device_sharded`` (4 ranks sharing one card)
and ``fused_sharded`` on the full cavity's configuration with R^3 roots,
and holds each to 2d's ``fused`` run by the forest after each event and a
digest of every block's interior bits (``sim_digests``). Its shape is cut
here to ``tests/test_torch_cavity_scale.py``'s: 4^3 roots, 8^3 cells, 4
ranks on the CPU (plain versions). Both sharded modes must grow the JAX
package's forest (ids, levels, owners), end within the cross-framework f32
tolerances of the JAX package's rank-sharded run (``JAX_MODE``) and
bitwise equal to the port's ``fused``.

The repairs the card's scale called for are held here too: each pattern's
rank plan cut from one compile of the whole forest equals the copied
compiler's plan of its levels, op for op and message for message; the
sharded engines' host fill after an event through that compile equals the
copied region-list fill bitwise, with the same messages and bytes; and the
sharded supersteps free a handed-over pre-step stack once its successor
exists.
"""

import importlib.util
import weakref
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
from repro_torch.lbm.halo import compile_rank_halo_plan, fill_ghost_layers_sharded
from repro_torch.lbm.plans import rank_pattern_plans
from torch_scale_runs import scale_run

REPO = Path(__file__).resolve().parents[1]
CUT_ROOTS = 4
CUT_CELLS = (8, 8, 8)
TOL = dict(rtol=3e-5, atol=3e-6)
SHARDED = ("device_sharded", "fused_sharded")
# the JAX package's rank-sharded data plane on the host: its conformance
# suite holds it and its fused_sharded to one single-rank reference within
# 1e-10, and it runs in 12 s here where fused_sharded's compiles take 43-49 s
JAX_MODE = "sharded"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_sharded_scale", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()
CUT = dict(CS.scale_cavity(CUT_ROOTS), cells_per_block=CUT_CELLS)


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _sim(mode: str, **over):
    return AMRLBM(LidDrivenCavityConfig(stepping_mode=mode, device="cpu", **CUT, **over))


@pytest.fixture(scope="module")
def runs():
    """Phase 2e's schedule in the port's sharded modes: mode -> (simulation,
    forest after each event, block digests after the last step); under
    ``"fused"`` and ``"jax"`` the futures of the port's ``fused`` run and
    the JAX package's ``JAX_MODE`` run (:func:`torch_scale_runs.scale_run`:
    forests, interiors, digests), started first in a process of their own,
    so that the runs here go on beside them."""
    torch.set_num_threads(1)
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        out = {"fused": pool.submit(scale_run, CUT, "fused", "torch"),
               "jax": pool.submit(scale_run, CUT, JAX_MODE, "jax")}
        for mode in SHARDED:
            sim = _sim(mode)
            forests = CS.scale_schedule(sim)
            out[mode] = (sim, forests, CS.sim_digests(sim))
        yield out


def _interiors(sim) -> dict:
    sim.materialize_host()
    return {b.bid: sim.spec.interior(np.asarray(b.data["pdf"])) for b in sim.forest.all_blocks()}


@pytest.mark.parametrize("mode", SHARDED)
def test_sharded_scale_run_equals_fused_bitwise(runs, mode):
    sim, forests, digests = runs[mode]
    fused_forests, want, fused_digests = runs["fused"].result()
    assert forests == fused_forests
    assert digests == fused_digests and len(digests) == sum(CS.lid_layer_blocks(CUT_ROOTS).values())
    got = _interiors(sim)
    assert got.keys() == want.keys() and all(np.array_equal(a, want[bid]) for bid, a in got.items())


# -- the block digest ---------------------------------------------------------


def test_digest_is_equal_for_equal_states_and_moves_with_one_ulp():
    rng = np.random.default_rng(5)
    stack = torch.as_tensor(rng.random((6, 19, 6, 6, 6), dtype=np.float32))
    base = CS.stack_digests(stack, 6, 1)
    assert len(set(base)) == 6
    assert CS.stack_digests(stack.clone(), 6, 1) == base
    for b, cell in ((0, (3, 1, 1, 1)), (4, (18, 4, 2, 3))):
        bumped = stack.clone()
        v = bumped[(b, *cell)]
        bumped[(b, *cell)] = torch.nextafter(v, torch.tensor(2.0))  # one ulp
        got = CS.stack_digests(bumped, 6, 1)
        assert [i for i in range(6) if got[i] != base[i]] == [b]
    ghost = stack.clone()
    ghost[2, :, 0] += 1.0  # a ghost cell is not part of the digest
    assert CS.stack_digests(ghost, 6, 1) == base


def test_digest_skips_pad_slots():
    rng = np.random.default_rng(6)
    real = torch.as_tensor(rng.random((3, 19, 6, 6, 6), dtype=np.float32))
    padded = torch.cat([real, torch.full((2, 19, 6, 6, 6), float("nan"))])
    assert CS.stack_digests(padded, 3, 1) == CS.stack_digests(real, 3, 1)
    assert len(CS.stack_digests(padded, 3, 1)) == 3


def test_device_sharded_digests_map_slots_to_blocks(runs):
    """``sim_digests`` of device_sharded reads each rank's padded stacks by
    its arena's slots: equal to the digest of each block's host interior."""
    sim, _forests, digests = runs["device_sharded"]
    eng = sim.engine
    eng.materialize_host()
    for r, arena in enumerate(eng.arenas.per_rank):
        for level in arena.levels():
            host = torch.from_numpy(arena.buffer(level, "pdf"))
            own = CS.stack_digests(host, host.shape[0], 1)
            for bid, slot in arena.slots(level).items():
                assert digests[bid] == own[slot], (r, level, bid)


# -- the repairs ---------------------------------------------------------------


def _rank_slots(eng) -> dict:
    return {r: {l: a.slots(l) for l in a.levels()} for r, a in enumerate(eng.arenas.per_rank)}


def test_rank_pattern_plans_equal_the_copys_compiles(runs):
    sim = runs["fused_sharded"][0]
    levels = sorted(sim.forest.levels_in_use())
    rank_slots = _rank_slots(sim.engine)
    whole = sim.engine._whole_rank_plan()  # compile_rank_forest_plan's, cached since the last event
    assert whole.levels == frozenset(levels)
    cut = rank_pattern_plans(whole, levels)
    assert sorted(cut) == [0, 1, 2]
    for p, plan in cut.items():
        want = compile_rank_halo_plan(sim.forest, sim.fields, rank_slots, fields=("pdf",),
                                      levels={l for l in levels if l >= levels[-1] - p})
        assert (plan.fields, plan.levels, sorted(plan.local)) == (want.fields, want.levels, sorted(want.local))
        assert len(plan.messages) == len(want.messages) > 0
        for r, local in plan.local.items():
            assert len(local.ops) == len(want.local[r].ops) > 0
            for a, b in zip(local.ops, want.local[r].ops):
                assert (a.field, a.dst_level, a.src_level, a.kind) == (b.field, b.dst_level, b.src_level, b.kind)
                for name in ("dst_slot", "dst_cell", "src_slot", "src_cell"):
                    np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
                    assert getattr(a, name).dtype == getattr(b, name).dtype
        for a, b in zip(plan.messages, want.messages):
            assert (a.key, a.nbytes, a.num_cells) == (b.key, b.nbytes, b.num_cells)
            assert len(a.gather) == len(b.gather) and len(a.scatter) == len(b.scatter)
            for (sl, kind, ss, sc), (sl2, kind2, ss2, sc2) in zip(a.gather, b.gather):
                assert (sl, kind) == (sl2, kind2)
                np.testing.assert_array_equal(ss, ss2)
                np.testing.assert_array_equal(sc, sc2)
            for (dl, db, dc, n), (dl2, db2, dc2, n2) in zip(a.scatter, b.scatter):
                assert (dl, n) == (dl2, n2)
                np.testing.assert_array_equal(db, db2)
                np.testing.assert_array_equal(dc, dc2)


@pytest.mark.parametrize("mode", SHARDED)
def test_sharded_host_fill_equals_the_copys_fill_bitwise(runs, mode):
    sim = runs[mode][0]
    eng = sim.engine
    eng.materialize_host()
    bufs = [(a, l) for a in eng.arenas.per_rank for l in a.levels()]
    before = []
    for a, l in bufs:  # the interiors, and -1 in every ghost cell
        b = np.full_like(a.buffer(l, "pdf"), -1.0)
        b[..., 1:-1, 1:-1, 1:-1] = a.buffer(l, "pdf")[..., 1:-1, 1:-1, 1:-1]
        a.buffer(l, "pdf")[...] = b
        before.append(b)
    s0 = sim.comm.stats.summary()
    eng.exchange_ghosts()  # the compiled plan, in place on the ranks' host stacks
    s1 = sim.comm.stats.summary()
    got = [a.buffer(l, "pdf").copy() for a, l in bufs]
    for (a, l), b in zip(bufs, before):
        a.buffer(l, "pdf")[...] = b
    fill_ghost_layers_sharded(sim.forest, sim.fields, sim.comm, fields=("pdf",))  # the copy's region lists
    s2 = sim.comm.stats.summary()
    for (a, l), g, b in zip(bufs, got, before):
        assert not np.array_equal(g, b)
        np.testing.assert_array_equal(g, a.buffer(l, "pdf"), err_msg=f"rank {a.rank} level {l}")
    for key in ("p2p_bytes", "p2p_messages"):
        assert s1[key] - s0[key] == s2[key] - s1[key] > 0, key


@pytest.mark.parametrize("handed_over", [True, False])
def test_device_superstep_frees_a_handed_over_stack(runs, handed_over):
    """Through ``DeviceShardedEngine.advance`` the superstep is handed the
    engine's stacks: a rank's finest pre-step stack is gone before the
    level steps again (two copies of the state at a time). Called with a
    dict whose caller keeps the stacks, as the engine did before, it stays
    (the third copy the card's scale cannot hold)."""
    sim = _sim("device_sharded")
    sim.advance(CS.SCALE_EVENTS[0])
    sim.adapt()  # the lid's layer refines: two levels, two substeps
    eng = sim.engine
    progs = eng._programs()
    first = weakref.ref(eng._dev_pdfs[0][-1])
    alive = []
    branches = progs.fn.branches
    for p, branch in enumerate(list(branches)):
        def record(state, _branch=branch):
            alive.append(first() is not None)
            return _branch(state)

        branches[p] = record
    if handed_over:
        sim.advance(1)
        assert eng._dev_pdfs is not None and first() is None
    else:
        kept = eng._dev_pdfs
        handed = dict(kept)
        progs.fn(handed)
        assert handed == {} and first() is not None
    assert len(alive) == progs.nsub > 1
    assert alive == ([True] + [False] * (progs.nsub - 1) if handed_over else [True] * progs.nsub)


def test_fused_sharded_advance_frees_a_taken_stack():
    """``FusedShardedEngine.advance`` takes its stacks from the residencies:
    a rank's finest pre-step stack is gone once its successor exists."""
    sim = _sim("fused_sharded")
    sim.advance(CS.SCALE_EVENTS[0])
    sim.adapt()  # the lid's layer refines: two levels, two substeps
    eng = sim.engine
    progs = eng._programs()
    lmax = progs.levels[-1]
    r = next(r for r in progs.ranks if lmax in progs.rank_levels[r])
    first = weakref.ref(eng.arenas.per_rank[r].device().fetch(lmax, "pdf"))
    alive = []
    for p in set(progs.pattern):  # on the CPU a rank's substep is one unsplit absorb
        fn = progs.absorbs[p][r]

        def record(*a, _fn=fn):
            alive.append(first() is not None)
            return _fn(*a)

        progs.absorbs[p][r] = record
    sim.advance(1)
    assert len(alive) == progs.nsub > 1
    assert alive == [True] + [False] * (progs.nsub - 1)


# -- against the JAX package (its run ends last) ------------------------------


@pytest.mark.parametrize("mode", SHARDED)
def test_sharded_scale_run_grows_the_jax_forest(runs, mode):
    sim, forests, _digests = runs[mode]
    assert sim.coarse_step == CS.SCALE_STEPS and sim.amr_cycles == len(CS.SCALE_EVENTS) == len(forests)
    assert forests == runs["jax"].result()[0]
    assert CS.blocks_per_level(sim) == CS.lid_layer_blocks(CUT_ROOTS)
    assert {r for _bid, _level, r in forests[-1]} == set(range(CUT["nranks"]))


@pytest.mark.parametrize("mode", SHARDED)
def test_sharded_scale_run_matches_the_jax_package(runs, mode):
    got, want = _interiors(runs[mode][0]), runs["jax"].result()[1]
    assert got.keys() == want.keys()
    for bid, a in got.items():
        np.testing.assert_allclose(a, want[bid], **TOL, err_msg=f"block {bid:#x}")
