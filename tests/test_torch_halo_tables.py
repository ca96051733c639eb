"""The halo route's ghost-source map (``ops.halo_map``) and the function the
route computes, on the CPU.

* The map of every merged fill of ``BASE``'s two-level forest and of the
  three-level forest of ``tests/torch_fill_cases.py`` names each fill row's
  source at its target once, holds -1 on every ghost cell that nothing
  fills, and maps no interior cell; a fine row's target is marked to stage
  its means exactly where the cell or a neighbour (any D3Q27 direction,
  wrapped within the block) is not fluid.
* A plain emulation of the kernel's reads, which takes each ghost value
  through the map from the row's source (one cell, or an octet's mean in
  the canonical order), equals ``halo_fill_ref`` followed by the stencil
  bitwise, in f32/f64 and D3Q19/D3Q27; so does the wrapper's halo route on
  CPU tensors, solo and over a member axis. The route refuses an ``out``
  that overlaps ``f`` or a source.
* The ensemble on the ``cuda`` backend (the plain path on CPU tensors)
  equals ``restack`` bitwise, member by member, across an AMR event.
"""

import numpy as np
import pytest
import torch
from torch_fill_cases import branch_fills, random_buffers, refined_forest

from repro_torch.kernels.lbm_collide.lbm_collide import (
    HALO_FINE_BIT,
    HALO_SEG_SHIFT,
    HALO_STAGE_BIT,
    lbm_stream_collide,
    member_coeffs,
)
from repro_torch.kernels.lbm_collide.ops import fill_tables, halo_map
from repro_torch.kernels.lbm_collide.ref import collision_coeffs, halo_stream_collide_ref, stream_collide_into
from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
from repro_torch.lbm.lattice import D3Q19, D3Q27
from repro_torch.serving import Ensemble

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
OFFSET_MASK = (1 << HALO_STAGE_BIT) - 1


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def forests():
    """name -> (forest, registry, arena, slots): BASE after its first AMR
    event (two levels) and the three-level refined forest."""
    sim = AMRLBM(LidDrivenCavityConfig(nranks=1, stepping_mode="fused", kernel_backend="ref", **BASE))
    sim.advance(4)
    sim.adapt()
    assert len(sim.arena.levels()) == 2
    out = {"base": (sim.forest, sim.fields, sim.arena)}
    out["three-level"] = refined_forest((6, 4, 8))
    return {k: (f, r, a, {l: a.slots(l) for l in a.levels()}) for k, (f, r, a) in out.items()}


def _masks(rng, shape):
    """A cell-type stack with walls, a lid and scattered obstacles, ghost
    ring included, so that bounce-back reads a filled ghost cell's own
    values and non-fluid ghost cells copy them."""
    m = (rng.random(shape) < 0.08).astype(np.int32)
    m[:, :, :, -1] = 2
    return torch.from_numpy(m)


def _level_maps(forest, reg, arena, slots, Q=D3Q19.Q, rng=None):
    """(pattern, level, index, mask, HaloMap) of every merged fill of the
    fused superstep's activity patterns, each over a cell-type stack."""
    rng = np.random.default_rng(1) if rng is None else rng
    index = {l: i for i, l in enumerate(arena.levels())}
    for p, fills in enumerate(branch_fills(forest, reg, slots)):
        for l, fill in fills.items():
            mask = _masks(rng, (arena.num_blocks(l), *arena.buffer(l, "pdf").shape[2:]))
            yield p, l, index, mask, halo_map(fill_tables(fill, index, "cpu"), mask, Q)


@pytest.mark.parametrize("name", ["base", "three-level"])
def test_halo_map_names_each_fill_row_at_its_target_once(forests, name):
    forest, reg, arena, slots = forests[name]
    kinds = set()
    for _p, l, _index, mask, hm in _level_maps(forest, reg, arena, slots):
        B, X, Y, Z = mask.shape
        n = X * Y * Z
        assert hm.cells.shape == mask.shape
        cells = hm.cells.view(B, -1).numpy()
        mapped = cells >= 0
        # every fill row's target holds its segment and the offset of its
        # source cell (a fine row's octet base) in a stack of Q directions;
        # nothing else is mapped
        # the cells whose own values the stencil may read: not fluid, or a
        # neighbour in some D3Q27 direction not fluid
        solid = mask.numpy() != 0
        reads = np.zeros_like(solid)
        for c in D3Q27.c:
            reads |= np.roll(solid, tuple(int(v) for v in c), axis=(1, 2, 3))
        reads = reads.reshape(B, -1)
        want = np.full_like(cells, -1)
        rows = 0
        for k, t in enumerate(hm.tables):
            kinds.add(t.kind)
            cell = t.src_cell.numpy()
            fine = t.kind == "fine"
            base = cell[:, 0] if fine else cell
            b, c = t.dst_slot.numpy(), t.dst_cell.numpy()
            stage = reads[b, c].astype(np.int64) if fine else 0
            want[b, c] = (t.src_slot.numpy().astype(np.int64) * D3Q19.Q * n + base
                          | k << HALO_SEG_SHIFT | int(fine) << HALO_FINE_BIT | stage << HALO_STAGE_BIT)
            rows += t.dst_slot.numel()
        np.testing.assert_array_equal(cells, want, err_msg=f"level {l}")
        # each fill row's target once
        assert mapped.sum() == rows
        # no interior cell is mapped; the ring's unfilled cells hold -1
        ring = np.ones((X, Y, Z), bool)
        ring[1:-1, 1:-1, 1:-1] = False
        assert not mapped[:, ~ring.ravel()].any()
        assert (cells[:, ring.ravel()][~mapped[:, ring.ravel()]] == -1).all()
        assert mapped[:, ring.ravel()].any()
    assert kinds >= {"same", "fine", "coarse"} or name == "base"


def _filled_through_map(f: torch.Tensor, hm, sources) -> torch.Tensor:
    """The buffer the halo kernel reads: ``f`` with every mapped cell's
    values taken as the kernel takes them, through its row's source (one
    cell, or the octet at the offset summed in the canonical order, then
    times 1/8)."""
    g = f.clone()
    B, Q, X, Y, Z = f.shape
    n = X * Y * Z
    flat = g.view(B, Q, n)
    b, c = (hm.cells.view(B, -1) >= 0).nonzero(as_tuple=True)
    e = hm.cells.view(B, -1)[b, c]
    planes = torch.arange(Q) * n
    for k, t in enumerate(hm.tables):
        sel = (e >> HALO_SEG_SHIFT) == k
        at = (e[sel] & OFFSET_MASK)[:, None] + planes  # (N, Q) element offsets
        src = sources[t.src].reshape(-1)
        assert bool(((e[sel] >> HALO_FINE_BIT) & 1 == int(t.kind == "fine")).all())
        if t.kind == "fine":
            acc = src[at]
            for d in (1, Z, Z + 1, Y * Z, Y * Z + 1, Y * Z + Z, Y * Z + Z + 1):
                acc = acc + src[at + d]
            vals = acc * 0.125
        else:
            vals = src[at]
        flat[b[sel], :, c[sel]] = vals
    return g


@pytest.mark.parametrize("name", ["base", "three-level"])
@pytest.mark.parametrize("lattice", [D3Q19, D3Q27], ids=["d3q19", "d3q27"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_reading_through_the_map_equals_fill_then_stencil_bitwise(forests, name, lattice, dtype):
    forest, reg, arena, slots = forests[name]
    rng = np.random.default_rng(5)
    bufs = tuple(random_buffers(rng, arena, lattice.Q, dtype))
    for p, l, index, mask, hm in _level_maps(forest, reg, arena, slots, lattice.Q, rng):
        i = index[l]
        f = bufs[i]
        collision = ("bgk", "trt")[p % 2]
        kw = dict(omega=1.3, lattice=lattice, u_wall=(0.05, 0.01, 0.0), collision=collision)
        coeffs = collision_coeffs(dtype=dtype, **kw)
        want = halo_stream_collide_ref(f, mask, coeffs, hm.tables, bufs, lattice=lattice, collision=collision)
        got = stream_collide_into(_filled_through_map(f, hm, bufs), mask, coeffs, lattice=lattice,
                                  collision=collision)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        route = lbm_stream_collide(f, mask, halo=hm, sources=bufs, **kw)
        torch.testing.assert_close(route, want, rtol=0, atol=0)
        # the route reads f and its sources and writes neither
        assert all(torch.equal(a, b) for a, b in zip(bufs, random_buffers(np.random.default_rng(5), arena,
                                                                          lattice.Q, dtype)))
        # the member axis: every member through the same map
        M = 3
        stacks = tuple(torch.stack([b * (1 + 1e-3 * m) for m in range(M)]) for b in bufs)
        physics = [(1.3, (0.05, 0.01, 0.0)), (1.6, (0.02, 0.0, 0.0)), (1.8, (0.0, 0.03, 0.01))]
        mc = member_coeffs([o for o, _u in physics], [u for _o, u in physics], lattice=lattice,
                           collision=collision, dtype=f.dtype)
        got_m = lbm_stream_collide(stacks[i], mask, members=mc, halo=hm, sources=stacks)
        for m, (omega, u_wall) in enumerate(physics):
            solo = lbm_stream_collide(stacks[i][m], mask, halo=hm, sources=tuple(s[m] for s in stacks),
                                      omega=omega, u_wall=u_wall, lattice=lattice, collision=collision)
            torch.testing.assert_close(got_m[m], solo, rtol=0, atol=0)


def test_halo_route_checks_its_operands(forests):
    forest, reg, arena, slots = forests["three-level"]
    _p, l, index, mask, hm = next(_level_maps(forest, reg, arena, slots))
    bufs = tuple(random_buffers(np.random.default_rng(0), arena, D3Q19.Q, np.float32))
    f = bufs[index[l]]
    with pytest.raises(ValueError, match="come together"):
        lbm_stream_collide(f, mask, omega=1.5, halo=hm)
    # the route takes a slot list of int32 block indices, and none over a
    # member axis
    with pytest.raises(ValueError, match="slots must be"):
        lbm_stream_collide(f, mask, omega=1.5, halo=hm, sources=bufs, slots=torch.zeros(1, dtype=torch.int64))
    mc = member_coeffs([1.5, 1.6], [(0.08, 0.0, 0.0)] * 2)
    with pytest.raises(ValueError, match="no slot list"):
        lbm_stream_collide(torch.stack([f, f]), mask, members=mc, halo=hm, sources=tuple(torch.stack([b, b]) for b in bufs),
                           slots=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="does not match"):
        lbm_stream_collide(f, mask, omega=1.5, halo=hm, sources=tuple(b.double() for b in bufs))
    with pytest.raises(ValueError, match="halo map must be"):
        lbm_stream_collide(f, mask, omega=1.5, halo=type(hm)(hm.cells.int(), hm.tables, mask), sources=bufs)
    with pytest.raises(ValueError, match="another mask"):
        lbm_stream_collide(f, mask.clone(), omega=1.5, halo=hm, sources=bufs)


@pytest.mark.parametrize("what", ["f", "a source"])
def test_halo_route_rejects_an_out_that_overlaps_its_inputs(forests, what):
    """The kernel stages values in ``out`` while other CTAs read ``f`` and
    the sources, so an ``out`` that shares bytes with any of them is
    refused; a fresh one is taken."""
    forest, reg, arena, slots = forests["three-level"]
    _p, l, index, mask, hm = next(_level_maps(forest, reg, arena, slots))
    sources = list(random_buffers(np.random.default_rng(0), arena, D3Q19.Q, np.float32))
    i = index[l]
    f = sources[i]
    want = lbm_stream_collide(f, mask, omega=1.5, halo=hm, sources=tuple(sources), out=torch.empty_like(f))
    if what == "f":  # f and out one block apart in one storage
        both = torch.cat([f, f[:1]])
        f, out = both[:-1], both[1:]
        sources[i] = f
    else:  # out is the first blocks of a larger stack among the sources
        sources.append(torch.cat([f, f]))
        out = sources[-1][: f.shape[0]]
    with pytest.raises(ValueError, match="must not overlap"):
        lbm_stream_collide(f, mask, omega=1.5, halo=hm, sources=tuple(sources), out=out)
    got = lbm_stream_collide(f, mask, omega=1.5, halo=hm, sources=tuple(sources), out=torch.empty_like(f))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_ensemble_on_the_cuda_backend_equals_restack_bitwise():
    """Two members batched after an AMR event (the halo route over their
    member axis, through its plain path on CPU tensors) end bitwise equal to
    their solo ``restack`` runs."""
    physics = [dict(omega=1.5), dict(omega=1.52)]
    members, refs = [], []
    for over in physics:
        for mode, backend, out in (("arena", "cuda", members), ("restack", "ref", refs)):
            sim = AMRLBM(LidDrivenCavityConfig(nranks=1, stepping_mode=mode, kernel_backend=backend,
                                               **{**BASE, **over}))
            sim.advance(4)
            sim.adapt()
            out.append(sim)
    assert len({tuple(sorted((b.bid, b.level) for b in s.forest.all_blocks())) for s in members}) == 1
    assert len(members[0].forest.levels_in_use()) == 2
    ens = Ensemble(members)
    ens.advance(2)
    ens.materialize()
    for sim, ref in zip(members, refs):
        ref.advance(2)
        want = {b.bid: ref.spec.interior(b.data["pdf"]) for b in ref.forest.all_blocks()}
        for b in sim.forest.all_blocks():
            np.testing.assert_array_equal(sim.spec.interior(b.data["pdf"]), want[b.bid])
