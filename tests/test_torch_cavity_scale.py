"""The cavity at the card's scale (``chip_smoke.py``'s phase 2d), held here on
the CPU at a cut size.

Phase 2d runs ``fused`` on the full cavity's configuration with R^3 roots
(``SCALE_ROOTS``): D3Q19 TRT f32, 32^3 cells a block, ``max_level=2``, 4
ranks, diffusion push-pull, AMR after coarse steps 4 and 8. Its shape is cut
here to 4^3 roots and 8^3 cells: the port's ``fused`` (plain versions on the
CPU) must grow the JAX package's forest after each event (ids, levels,
owners) and end with the same interior fields within the cross-framework f32
tolerances. The lid grows one layer of refinement a level, so R^3 roots hold
R^3 - R^2 level-0, 4 R^2 level-1 and 32 R^2 level-2 blocks after the second
event; the phase's plan (its level-2 stack past 2^31 elements, its bytes a
block under the card's memory) is checked from its constants.

The repairs the card's scale called for are held here too: each pattern's
ghost plan cut from one compile of the whole forest equals the copied
compiler's plan of its levels; ``fused``'s host fill after an event through
that plan equals the copied host fill bitwise; the superstep frees a stack
it is handed in a list before the level steps again (the third copy of the
finest level's stack that a tuple's caller keeps); and a buffer taken from
the residency must be stored back before it is read.
"""

import importlib.util
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.lbm import AMRLBM as JaxAMRLBM
from repro.lbm import LidDrivenCavityConfig as JaxConfig
from repro_torch.kernels.lbm_collide.ops import HaloStep, make_fused_superstep, make_halo_stream_collide, make_stream_collide
from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
from repro_torch.lbm.forests import refined_forest
from repro_torch.lbm.grid import CellType
from repro_torch.lbm.halo import compile_ghost_plan, fill_ghost_layers
from repro_torch.lbm.lattice import D3Q19
from repro_torch.lbm.plans import compile_forest_plan, pattern_plans

REPO = Path(__file__).resolve().parents[1]
CUT_ROOTS = 4
CUT_CELLS = (8, 8, 8)
TOL = dict(rtol=3e-5, atol=3e-6)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_scale", REPO / "chip_smoke.py")
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


def _forest(sim) -> set:
    return {(b.bid, b.level, b.owner) for b in sim.forest.all_blocks()}


def _levels(sim) -> dict:
    levels: dict = {}
    for b in sim.forest.all_blocks():
        levels[b.level] = levels.get(b.level, 0) + 1
    return dict(sorted(levels.items()))


def _run(sim) -> list[set]:
    """Phase 2d's schedule up to its second event: adapt() after the steps
    of ``SCALE_EVENTS``, recording the forest after each."""
    forests = []
    for i in range(max(CS.SCALE_EVENTS)):
        sim.advance(1)
        if i + 1 in CS.SCALE_EVENTS:
            sim.adapt()
            forests.append(_forest(sim))
    return forests


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    sim = AMRLBM(LidDrivenCavityConfig(stepping_mode="fused", device="cpu", **CUT))
    ref = JaxAMRLBM(JaxConfig(stepping_mode="fused", kernel_backend="ref", **CUT))
    masses = [sim.total_mass()]
    forests = _run(sim)
    masses.append(sim.total_mass())
    return sim, forests, masses, ref, _run(ref)


def test_cut_scale_run_matches_the_jax_package(runs):
    sim, forests, masses, ref, ref_forests = runs
    assert sim.amr_cycles == len(CS.SCALE_EVENTS) == len(forests)
    assert forests == ref_forests
    assert _levels(sim) == CS.lid_layer_blocks(CUT_ROOTS) == {0: 48, 1: 64, 2: 512}
    sim.materialize_host()
    ref.materialize_host()
    want = {b.bid: b for b in ref.forest.all_blocks()}
    for b in sim.forest.all_blocks():
        np.testing.assert_allclose(sim.spec.interior(b.data["pdf"]),
                                   ref.spec.interior(np.asarray(want[b.bid].data["pdf"])), **TOL)
    drift = abs(masses[1] - masses[0]) / masses[0]
    assert drift < 1e-5, drift


def test_first_event_refines_the_lid_layer(runs):
    _sim, forests, _masses, _ref, _ref_forests = runs
    levels = {}
    for _bid, level, _owner in forests[0]:
        levels[level] = levels.get(level, 0) + 1
    # the top layer of roots refines into 8 children each
    assert levels == {0: CUT_ROOTS**3 - CUT_ROOTS**2, 1: 8 * CUT_ROOTS**2}


@pytest.mark.parametrize("roots", [CS.SCALE_ROOTS, 11])
def test_scale_plan_fits_the_card(roots):
    blocks = CS.lid_layer_blocks(roots)
    cfg = CS.scale_cavity(roots)
    ghosted = int(np.prod([n + 2 * cfg["ghost"] for n in cfg["cells_per_block"]]))
    # D3Q19 f32: level 2's pdf stack past the int32 range
    assert blocks[2] * 19 * ghosted >= 2**31
    need = sum(blocks.values()) * CS.SCALE_BYTES_PER_BLOCK + CS.SCALE_RESIDENT_BYTES
    assert need <= CS.SCALE_MEMORY_SHARE * CS.SCALE_CARD_BYTES, (roots, need / 1e9)


# -- the repairs the card's scale called for ----------------------------------


def test_pattern_plans_equal_the_copys_compiles():
    forest, reg, arena = refined_forest((4, 4, 4), depth=2)
    levels = arena.levels()
    slots = {l: arena.slots(l) for l in levels}
    cut = pattern_plans(compile_forest_plan(forest, reg, slots, levels), levels)
    assert sorted(cut) == [0, 1, 2]
    for p, plan in cut.items():
        want = compile_ghost_plan(forest, reg, slots, fields=("pdf",), levels={l for l in levels if l >= 2 - p})
        assert (plan.fields, plan.levels) == (want.fields, want.levels)
        assert len(plan.ops) == len(want.ops) > 0
        for a, b in zip(plan.ops, want.ops):
            assert (a.field, a.dst_level, a.src_level, a.kind) == (b.field, b.dst_level, b.src_level, b.kind)
            for name in ("dst_slot", "dst_cell", "src_slot", "src_cell"):
                np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
                assert getattr(a, name).dtype == getattr(b, name).dtype


def test_fused_host_fill_equals_the_host_plans_bitwise(runs):
    sim = runs[0]
    sim.materialize_host()
    levels = sim.forest.levels_in_use()
    before = {}
    for l in levels:  # the interiors, and -1 in every ghost cell
        before[l] = np.full_like(sim.arena.buffer(l, "pdf"), -1.0)
        before[l][..., 1:-1, 1:-1, 1:-1] = sim.arena.buffer(l, "pdf")[..., 1:-1, 1:-1, 1:-1]
        sim.arena.buffer(l, "pdf")[...] = before[l]
    sim.engine.exchange_ghosts()  # the compiled plan, in place on the host stacks
    got = {l: sim.arena.buffer(l, "pdf").copy() for l in levels}
    for l in levels:
        sim.arena.buffer(l, "pdf")[...] = before[l]
    fill_ghost_layers(sim.forest, sim.fields, fields=("pdf",))  # the copy's host plan
    for l in levels:
        assert not np.array_equal(got[l], before[l])
        np.testing.assert_array_equal(got[l], sim.arena.buffer(l, "pdf"), err_msg=f"level {l}")


@pytest.mark.parametrize("handed_over", [True, False])
def test_superstep_frees_a_handed_over_stack(handed_over):
    """Handed over in a list, the finest level's pre-step stack is gone
    before the level steps again (two copies of the state at a time);
    passed as a tuple its caller keeps it (the third copy the card-scale
    cavity's peak held before)."""
    forest, reg, arena = refined_forest((4, 4, 4), depth=2)
    levels = arena.levels()
    lmax = levels[-1]
    rng = np.random.default_rng(3)
    stacks = [torch.as_tensor(0.05 + 0.01 * rng.random(arena.buffer(l, "pdf").shape, dtype=np.float32))
              for l in levels]
    masks = {l: torch.from_numpy(arena.buffer(l, "mask")).clone() for l in levels}
    kw = dict(omega=1.5, lattice=D3Q19, u_wall=(0.08, 0.0, 0.0), collision="trt", backend="cuda")
    first = weakref.ref(stacks[-1])
    alive, sizes = [], []  # at each step of the finest level

    def factory(level, fill, level_index, messages=()):
        h = make_halo_stream_collide(fill, level_index, mask=masks[level], device="cpu", **kw)

        def step(f, filled, **k):
            if level == lmax:
                alive.append(first() is not None)
                sizes.append(len(inputs))
            return h.step(f, filled, **k)

        return HaloStep(h.fill, step)

    slots = {l: arena.slots(l) for l in levels}
    fn = make_fused_superstep(
        levels=levels, plans=pattern_plans(compile_forest_plan(forest, reg, slots, levels), levels),
        steppers={l: make_stream_collide(**kw) for l in levels}, masks=masks, halo_stepper_factory=factory,
    )
    inputs = stacks if handed_over else tuple(stacks)
    del stacks
    out = fn(inputs)
    assert len(out) == len(levels) and len(alive) == 2**lmax
    if handed_over:
        assert sizes == [0] * 2**lmax and alive == [True] + [False] * (2**lmax - 1)
    else:
        assert sizes == [len(levels)] * 2**lmax and alive == [True] * 2**lmax


def test_a_taken_residency_buffer_must_be_stored_back():
    _forest, _reg, arena = refined_forest((4, 4, 4), depth=1)
    res = arena.device(torch.device("cpu"))
    level = arena.levels()[-1]
    taken = res.take(level, "pdf")
    with pytest.raises(AssertionError, match="taken"):
        res.fetch(level, "pdf")
    res.store(level, "pdf", taken + 1)
    res.flush()
    np.testing.assert_array_equal(arena.buffer(level, "pdf"), (taken + 1).numpy())


def test_masks_equal_the_full_grid_of_centers(runs):
    """The walls and the lid tested axis by axis, as ``refresh_masks`` now
    does, against the same tests on every cell center (the copy's way)."""
    sim = runs[0]
    top = float(sim.geom.root_grid[2])
    for b in sim.forest.all_blocks():
        xyz = sim._cell_centers(b)
        want = np.zeros(xyz.shape[:-1], dtype=np.int32)
        outside = ((xyz[..., 0] < 0.0) | (xyz[..., 0] > sim.geom.root_grid[0]) | (xyz[..., 1] < 0.0)
                   | (xyz[..., 1] > sim.geom.root_grid[1]) | (xyz[..., 2] < 0.0))
        want[outside] = CellType.WALL
        want[xyz[..., 2] > top] = CellType.LID
        np.testing.assert_array_equal(b.data["mask"], want)
