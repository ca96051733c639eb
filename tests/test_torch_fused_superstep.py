"""The port's device-resident fused superstep and its building blocks.

* the compiled ghost plan, run as PyTorch index ops, reproduces the port's
  host ``fill_ghost_layers`` bit for bit (fine->coarse coalescence and
  coarse->fine explosion included, float and int fields);
* ``fused`` equals ``restack`` bitwise on the CPU, on both backends (the
  ``cuda`` backend takes the kernels' plain versions for CPU tensors, so
  this pins the from-sources fill schedule end to end: every level's fill
  in place first, then every level's stencil);
* between AMR events the fused loop performs no host<->device transfer.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_fill_cases import branch_fills, refined_forest

from repro_torch.core import AMRPipeline, Comm, ForestGeometry, LevelArena, SFCBalancer, make_uniform_forest
from repro_torch.kernels.lbm_collide import ops
from repro_torch.kernels.lbm_collide.ops import apply_compiled_ghost_plan
from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
from repro_torch.lbm.grid import LBMBlockSpec, make_lbm_fields
from repro_torch.lbm.halo import compile_ghost_plan, fill_ghost_layers

BASE = dict(
    root_grid=(2, 2, 2),
    cells_per_block=(8, 8, 8),
    omega=1.5,
    u_lid=(0.08, 0.0, 0.0),
    max_level=1,
    refine_upper=0.03,
    refine_lower=0.004,
    device="cpu",
)


def _seed_fields(forest, reg, rng=None):
    for b in forest.all_blocks():
        shape = reg.block_shape("pdf")
        b.data["pdf"] = (
            np.full(shape, float(b.bid % 97), np.float32)
            if rng is None
            else rng.standard_normal(shape).astype(np.float32)
        )
        b.data["mask"] = np.zeros(reg.block_shape("mask"), np.int32)


def _two_level_arena(cells=(4, 4, 4)):
    """A 2-level forest (one root refined) with arena-backed random pdfs."""
    reg = make_lbm_fields(LBMBlockSpec(cells=cells))
    geom = ForestGeometry(root_grid=(2, 1, 1), max_level=6)
    forest = make_uniform_forest(geom, 1, level=0)
    _seed_fields(forest, reg)
    pipe = AMRPipeline(balancer=SFCBalancer(), registry=reg)
    root0 = min(b.bid for b in forest.all_blocks())
    forest, _ = pipe.run_cycle(forest, Comm(1), lambda r, blocks: {root0: 1})
    assert forest.levels_in_use() == [0, 1]
    _seed_fields(forest, reg, rng=np.random.default_rng(7))
    arena = LevelArena(reg)
    arena.adopt(forest)
    return forest, reg, arena


@pytest.mark.parametrize("field", ["pdf", "mask"])
def test_compiled_plan_matches_host_exchange_bitwise(field):
    forest, reg, arena = _two_level_arena()
    if field == "mask":  # int field: the fine path must truncate, not zero
        rng = np.random.default_rng(11)
        for b in forest.all_blocks():
            b.data["mask"][...] = rng.integers(0, 3, b.data["mask"].shape)
    plan = compile_ghost_plan(
        forest, reg, {l: arena.slots(l) for l in arena.levels()}, fields=(field,)
    )
    assert {op.kind for op in plan.ops} == {"same", "fine", "coarse"}
    out = apply_compiled_ghost_plan(
        plan, {l: np.array(arena.buffer(l, field)) for l in arena.levels()}
    )
    fill_ghost_layers(forest, reg, fields=(field,))  # host reference, in place
    for l in arena.levels():
        got = out[l].numpy()
        assert got.any()
        np.testing.assert_array_equal(got, arena.buffer(l, field), err_msg=f"level {l}")


def _run(mode: str, backend: str) -> AMRLBM:
    sim = AMRLBM(LidDrivenCavityConfig(nranks=1, stepping_mode=mode, kernel_backend=backend, **BASE))
    sim.run(8, amr_interval=4)
    return sim


@pytest.fixture(scope="module")
def restack() -> AMRLBM:
    return _run("restack", "ref")


@pytest.mark.parametrize("mode, backend", [("fused", "ref"), ("fused", "cuda"), ("arena", "cuda")])
def test_modes_match_restack_bitwise(restack, mode, backend):
    sim = _run(mode, backend)
    assert sim.amr_cycles >= 1 and len(sim.forest.levels_in_use()) > 1
    sim.materialize_host()
    ref = {b.bid: b for b in restack.forest.all_blocks()}
    got = {b.bid: b for b in sim.forest.all_blocks()}
    assert {(b, x.level, x.owner) for b, x in ref.items()} == {
        (b, x.level, x.owner) for b, x in got.items()
    }
    for bid, blk in got.items():
        np.testing.assert_array_equal(
            sim.spec.interior(blk.data["pdf"]), sim.spec.interior(ref[bid].data["pdf"])
        )
    assert sim.total_mass() == restack.total_mass()


def test_fused_cuda_backend_fills_from_sources_before_any_stencil(monkeypatch):
    """On the ``cuda`` backend the fill from sources is folded into the
    stencil: a substep launches one halo-route stencil per active level with
    a fill, reading its ghost values from the substep's pre-step tuple, and
    a plain stencil per other active level; nothing fills and nothing
    gathers fill values."""
    calls = []
    stencil = ops.lbm_stream_collide

    def spy_stencil(f, mask, **kw):
        sources = kw.get("sources")
        # the tuple itself is kept, so that no two substeps' tuples share an id
        calls.append(("halo", sources, any(s is f for s in sources)) if kw.get("halo") else ("stencil",))
        return stencil(f, mask, **kw)

    def no_fill(*args):
        raise AssertionError("the cuda backend launched a separate fill")

    def no_gather(*args):
        raise AssertionError("the cuda backend gathered fill values")

    monkeypatch.setattr(ops, "lbm_halo_fill", no_fill)
    monkeypatch.setattr(ops, "lbm_stream_collide", spy_stencil)
    monkeypatch.setattr(ops, "_concat_vals", no_gather)
    sim = AMRLBM(LidDrivenCavityConfig(nranks=1, stepping_mode="fused", kernel_backend="cuda", **BASE))
    sim.advance(2)
    sim.adapt()
    assert len(sim.forest.levels_in_use()) > 1
    calls.clear()
    fn, levels = sim.engine._fused_program()
    sim.advance(1)
    halo = [c for c in calls if c[0] == "halo"]
    assert len(halo) == fn.halo_steps > 0
    # each halo step steps a stack of the tuple it reads its sources from
    assert all(c[2] for c in halo)
    # one stencil launch per active level a substep
    lmax = max(levels)
    assert len(calls) == sum(len([l for l in levels if l >= lmax - p]) for p in _substep_patterns(lmax))
    # the finest level's halo steps of successive substeps read successive tuples
    assert len({id(c[1]) for c in halo}) == 1 << lmax


def test_fused_steady_state_performs_zero_host_transfers():
    sim = AMRLBM(LidDrivenCavityConfig(nranks=1, stepping_mode="fused", kernel_backend="cuda", **BASE))
    sim.advance(2)
    sim.adapt()
    assert len(sim.forest.levels_in_use()) > 1
    sim.advance(1)  # rebuilds the superstep + uploads pdf/mask after the event
    res = sim.arena.device()
    before = (res.h2d_transfers, res.d2h_transfers)
    assert res.h2d_transfers > 0
    sim.advance(3)  # 3 coarse steps = 3 * 2^lmax substeps, all on the device
    assert (res.h2d_transfers, res.d2h_transfers) == before
    lmax = max(sim.forest.levels_in_use())
    assert sim.data_stats["fused"].exchange_rounds == 2 + 4 * 2**lmax
    sim.total_mass()  # diagnostics rematerialize host views: flushes only
    assert res.h2d_transfers == before[0] and res.d2h_transfers > before[1]
    d2h = res.d2h_transfers
    sim.total_mass()  # already synced: no second download
    assert res.d2h_transfers == d2h


@pytest.mark.parametrize("backend", ["cuda", "ref"])
def test_patterns_with_the_same_fill_share_one_halo_step(backend):
    """A level whose merged fill is the same in several activity patterns
    gets its halo step (fill tables, mask) built once; the fill launches a
    coarse step counts stay one per (active level, segment) a substep.
    ``test_modes_match_restack_bitwise`` runs the shared steps end to end."""
    forest, reg, arena = refined_forest()
    levels = arena.levels()
    slots = {l: arena.slots(l) for l in levels}
    fills = branch_fills(forest, reg, slots)
    total = sum(len(f) for f in fills)
    distinct = []
    for fl in fills:
        for l, f in fl.items():
            if not any(l == m and ops._same_fill(f, g) for m, g in distinct):
                distinct.append((l, f))
    assert len(distinct) < total, "the finest level's fill repeats across patterns"

    built = []

    def factory(level, fill, level_index):
        built.append((level, fill))
        return ops.make_halo_stream_collide(
            fill, level_index, mask=arena.buffer(level, "mask"), omega=1.5,
            u_wall=(0.08, 0.0, 0.0), collision="trt", backend=backend, device="cpu",
        )

    masks = {l: torch.as_tensor(arena.buffer(l, "mask")) for l in levels}
    steppers = {l: ops.make_stream_collide(omega=1.5, collision="trt", backend=backend) for l in levels}
    plans = {p: compile_ghost_plan(forest, reg, slots, fields=("pdf",),
                                   levels={l for l in levels if l >= levels[-1] - p})
             for p in range(levels[-1] + 1)}
    fn = ops.make_fused_superstep(levels=levels, plans=plans, steppers=steppers, masks=masks,
                                  halo_stepper_factory=factory)
    assert len(built) == len(distinct)
    assert fn.fill_segments == sum(
        len(fills[p][l].segments) for p in _substep_patterns(levels[-1]) for l in fills[p]
    )


def _substep_patterns(lmax):
    """Activity pattern of each substep of a coarse step (trailing zeros)."""
    return [lmax if s == 0 else min((s & -s).bit_length() - 1, lmax) for s in range(1 << lmax)]


def test_same_fill_tells_index_maps_apart():
    forest, reg, arena = refined_forest()
    slots = {l: arena.slots(l) for l in arena.levels()}
    fills = branch_fills(forest, reg, slots)[-1]
    f = fills[max(fills)]
    assert ops._same_fill(f, dataclasses.replace(f, dst_cell=f.dst_cell.copy()))
    moved = f.dst_cell.copy()
    moved[0] += 1
    assert not ops._same_fill(f, dataclasses.replace(f, dst_cell=moved))
    seg = f.segments[0]
    src = seg.src_cell.copy()
    src.flat[0] += 1
    other = dataclasses.replace(f, segments=(dataclasses.replace(seg, src_cell=src),) + f.segments[1:])
    assert not ops._same_fill(f, other)
    assert not ops._same_fill(f, dataclasses.replace(f, segments=f.segments[:-1]))
