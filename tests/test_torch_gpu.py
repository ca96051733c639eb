"""The port's CUDA kernels on the card, held against their plain versions;
the LM serving and training paths on the card against the CPU.

Imports no jax, so it runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tests marked ``gpu`` skip (inside the test) where there is no card. f32
compares at rtol 3e-5 / atol 3e-6 and f64 at 1e-12: the kernel sums the
moments in fixed q order, the plain version through ``einsum``.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.lbm_collide.lbm_collide import (
    lbm_halo_fill,
    lbm_stream_collide,
    lbm_stream_collide_halo,
    member_coeffs,
)
from repro_torch.kernels.lbm_collide.ops import FillTable, _pad_fill_layout, fill_tables, halo_map
from repro_torch.kernels.lbm_collide.ref import (
    CT_LID,
    CT_WALL,
    collision_coeffs,
    halo_fill_ref,
    halo_stream_collide_ref,
    stream_collide_ref,
)
from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
from repro_torch.lbm.lattice import D3Q19, D3Q27
from repro_torch.models import build_model
from repro_torch.serving import JobSpec, SimulationService
from repro_torch.train import make_serve_step
from torch_fill_cases import branch_fills, random_buffers, refined_forest

TOL = {np.float32: dict(rtol=3e-5, atol=3e-6), np.float64: dict(rtol=1e-11, atol=1e-12)}


def _random_state(rng, B, lattice, shape, dtype):
    w = np.asarray(lattice.w, dtype=dtype)
    f = w[None, :, None, None, None] * (
        1.0 + 0.05 * rng.standard_normal((B, lattice.Q, *shape))
    ).astype(dtype)
    mask = np.zeros((B, *shape), np.int32)
    mask[:, 0] = CT_WALL
    mask[:, -1] = CT_LID
    mask[:, :, 0] = CT_WALL
    return f, mask


def _random_halo(rng, B, lattice, dims, dtype):
    """Random distinct ghost-ring targets per block, padded per block."""
    X, Y, Z = dims
    ring = [
        (x * Y + y) * Z + z
        for x in range(X) for y in range(Y) for z in range(Z)
        if min(x, y, z) == 0 or x == X - 1 or y == Y - 1 or z == Z - 1
    ]
    slots, cells = [], []
    for b in range(B):
        pick = rng.choice(ring, size=3 + 4 * b, replace=False)
        slots += [b] * len(pick)
        cells += list(pick)
    vals = (rng.standard_normal((len(cells), lattice.Q)) * 0.01 + 0.05).astype(dtype)
    entry, cell, valid = _pad_fill_layout(np.asarray(slots), np.asarray(cells), B, dims)
    return vals[entry], cell, valid


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_cpu_tensors_take_the_plain_version_without_counting():
    rng = np.random.default_rng(0)
    f, mask = _random_state(rng, 2, D3Q19, (4, 4, 4), np.float32)
    before = lbm_stream_collide.launches
    got = lbm_stream_collide(torch.from_numpy(f), torch.from_numpy(mask), omega=1.3)
    want = stream_collide_ref(torch.from_numpy(f), torch.from_numpy(mask), omega=1.3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert lbm_stream_collide.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize(
    "lattice, collision, dtype, shape",
    [
        (D3Q19, "trt", np.float32, (10, 10, 10)),
        (D3Q27, "bgk", np.float32, (6, 8, 10)),
        (D3Q19, "bgk", np.float64, (5, 7, 3)),
        (D3Q27, "trt", np.float64, (4, 6, 5)),
    ],
    ids=["d3q19-trt-f32", "d3q27-bgk-f32", "d3q19-bgk-f64-odd", "d3q27-trt-f64-odd"],
)
def test_cuda_kernels_match_plain_on_card(lattice, collision, dtype, shape):
    _require_card()
    rng = np.random.default_rng(11)
    B = 3
    f, mask = _random_state(rng, B, lattice, shape, dtype)
    kw = dict(omega=1.4, lattice=lattice, collision=collision, u_wall=(0.05, 0.01, 0.0))
    fd, md = torch.from_numpy(f).cuda(), torch.from_numpy(mask).cuda()
    n0 = lbm_stream_collide.launches
    got = lbm_stream_collide(fd, md, **kw)
    torch.cuda.synchronize()
    assert lbm_stream_collide.launches == n0 + 1
    torch.testing.assert_close(got, stream_collide_ref(fd, md, **kw), **TOL[dtype])

    hv, cell, valid = (torch.from_numpy(a) for a in _random_halo(rng, B, lattice, shape, dtype))
    want = lbm_stream_collide_halo(fd.cpu(), md.cpu(), hv, cell, valid, **kw)
    n0 = lbm_stream_collide_halo.launches
    got = lbm_stream_collide_halo(fd.clone(), md, hv.cuda(), cell.cuda(), valid.cuda(), **kw)
    torch.cuda.synchronize()
    assert lbm_stream_collide_halo.launches == n0 + 1
    torch.testing.assert_close(got.cpu(), want, **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize(
    "lattice, collision, dtype, shape",
    [
        (D3Q19, "trt", np.float32, (34, 34, 34)),
        (D3Q19, "trt", np.float32, (33, 17, 35)),
        (D3Q27, "bgk", np.float64, (9, 11, 7)),
    ],
    ids=["34-cube", "33x17x35", "9x11x7"],
)
def test_stencil_tiles_cover_every_extent_on_card(lattice, collision, dtype, shape):
    _require_card()
    rng = np.random.default_rng(5)
    f, mask = _random_state(rng, 2, lattice, shape, dtype)
    kw = dict(omega=1.6, lattice=lattice, collision=collision, u_wall=(0.05, 0.0, 0.01))
    fd, md = torch.from_numpy(f).cuda(), torch.from_numpy(mask).cuda()
    got = lbm_stream_collide(fd, md, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, stream_collide_ref(fd, md, **kw), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("lattice", [D3Q19, D3Q27], ids=["d3q19", "d3q27"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_fill_kernel_matches_plain_on_card(lattice, dtype):
    """Every segment of every branch of a three-level forest (``same``,
    ``coarse`` and ``fine`` segments), kernel against plain version."""
    _require_card()
    forest, reg, arena = refined_forest(cells=(6, 4, 8))
    index = {l: i for i, l in enumerate(arena.levels())}
    bufs = random_buffers(np.random.default_rng(2), arena, lattice.Q, dtype, device="cuda")
    kinds = set()
    for fills in branch_fills(forest, reg, {l: arena.slots(l) for l in arena.levels()}):
        for l, fill in fills.items():
            for t in fill_tables(fill, index, "cuda"):
                kinds.add(t.kind)
                args = (t.kind, t.dst_slot, t.dst_cell, t.src_slot, t.src_cell)
                got, want = bufs[index[l]].clone(), bufs[index[l]].clone()
                src = got if t.src == index[l] else bufs[t.src]
                n0 = lbm_halo_fill.launches
                lbm_halo_fill(got, src, *args)
                torch.cuda.synchronize()
                assert lbm_halo_fill.launches == n0 + 1
                halo_fill_ref(want, want if t.src == index[l] else bufs[t.src], *args)
                torch.testing.assert_close(got, want, **TOL[dtype])
    assert kinds == {"same", "coarse", "fine"}


@pytest.mark.gpu
def test_fused_cuda_run_matches_restack_on_card():
    _require_card()
    base = dict(
        root_grid=(2, 2, 2), cells_per_block=(8, 8, 8), omega=1.5, u_lid=(0.08, 0.0, 0.0),
        max_level=1, refine_upper=0.03, refine_lower=0.004, nranks=1,
    )
    sims = {}
    for mode, backend in (("restack", "cuda"), ("fused", "cuda"), ("fused", "ref")):
        sim = AMRLBM(LidDrivenCavityConfig(stepping_mode=mode, kernel_backend=backend, **base))
        assert sim.device.type == "cuda"
        sim.run(8, amr_interval=4)
        sim.materialize_host()
        sims[mode, backend] = sim
    ref = sims["restack", "cuda"]
    want = {b.bid: ref.spec.interior(b.data["pdf"]) for b in ref.forest.all_blocks()}
    for sim in sims.values():
        got = {b.bid: sim.spec.interior(b.data["pdf"]) for b in sim.forest.all_blocks()}
        assert got.keys() == want.keys()
        for bid, arr in got.items():
            np.testing.assert_allclose(arr, want[bid], **TOL[np.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_slot_list_stencil_matches_plain_on_card(dtype):
    """The stencil over a slot list steps exactly the listed blocks into
    ``out`` and leaves the others as ``out`` had them."""
    _require_card()
    rng = np.random.default_rng(21)
    B = 7
    f, mask = _random_state(rng, B, D3Q19, (10, 12, 14), dtype)
    kw = dict(omega=1.4, lattice=D3Q19, collision="trt", u_wall=(0.05, 0.01, 0.0))
    fd, md = torch.from_numpy(f).cuda(), torch.from_numpy(mask).cuda()
    slots = torch.tensor([5, 0, 3], dtype=torch.int32, device="cuda")
    sentinel = torch.full_like(fd, -7.0)
    out = sentinel.clone()
    n0 = lbm_stream_collide.launches
    got = lbm_stream_collide(fd, md, slots=slots, out=out, **kw)
    torch.cuda.synchronize()
    assert got is out and lbm_stream_collide.launches == n0 + 1
    want = lbm_stream_collide(fd.cpu(), md.cpu(), slots=slots.cpu(), out=sentinel.cpu(), **kw)
    listed = slots.long().cpu()
    torch.testing.assert_close(got.cpu()[listed], want[listed], **TOL[dtype])
    rest = torch.tensor([b for b in range(B) if b not in listed.tolist()])
    torch.testing.assert_close(got.cpu()[rest], sentinel.cpu()[rest], rtol=0, atol=0)
    # the slot list's blocks equal the whole stack's step, bit for bit
    whole = lbm_stream_collide(fd, md, **kw)
    torch.testing.assert_close(got[slots.long()], whole[slots.long()], rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_values_fill_matches_plain_on_card(dtype):
    """The ``values`` fill with no valid array writes every row of an (N, Q)
    slice into its target, bitwise the plain scatter."""
    _require_card()
    rng = np.random.default_rng(8)
    B, dims = 5, (6, 8, 10)
    X, Y, Z = dims
    ring = np.flatnonzero(np.pad(np.zeros((X - 2, Y - 2, Z - 2), bool), 1, constant_values=True))
    slots = np.repeat(np.arange(B), 40)
    cells = np.concatenate([rng.choice(ring, 40, replace=False) for _ in range(B)])
    order = rng.permutation(slots.size)  # a message's rows come in no sorted order
    ds = torch.as_tensor(slots[order], dtype=torch.int32)
    dc = torch.as_tensor(cells[order], dtype=torch.int32)
    payload = torch.as_tensor(rng.standard_normal((slots.size + 9, 19)), dtype=torch.float64 if dtype == np.float64 else torch.float32)
    seg = payload[9:]  # a slice of a message, as the absorb passes it
    dst = torch.as_tensor(rng.standard_normal((B, 19, *dims)), dtype=seg.dtype)
    want = dst.clone()
    halo_fill_ref(want, seg, "values", ds, dc)
    got = dst.cuda()
    n0 = lbm_halo_fill.launches
    lbm_halo_fill(got, payload.cuda()[9:], "values", ds.cuda(), dc.cuda())
    torch.cuda.synchronize()
    assert lbm_halo_fill.launches == n0 + 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.gpu
def test_fused_sharded_cuda_run_matches_fused_bitwise_on_card():
    """``fused_sharded`` on the kernels (split absorb, the card's default)
    grows the forest ``fused`` grows and steps every block's interior to the
    same bits: both run the same block-local, fixed-order kernels."""
    _require_card()
    base = dict(
        root_grid=(2, 2, 2), cells_per_block=(8, 8, 8), omega=1.5, u_lid=(0.08, 0.0, 0.0),
        max_level=1, refine_upper=0.03, refine_lower=0.004, nranks=4,
    )
    sims = {}
    for mode in ("fused", "fused_sharded"):
        sim = AMRLBM(LidDrivenCavityConfig(stepping_mode=mode, kernel_backend="cuda", **base))
        assert sim.device.type == "cuda"
        sim.run(8, amr_interval=4)
        sim.materialize_host()
        sims[mode] = sim
    assert sims["fused_sharded"].engine.split
    assert any(sims["fused_sharded"].engine._programs().interiors.values())
    ref, got = sims["fused"], sims["fused_sharded"]
    assert {(b.bid, b.level, b.owner) for b in got.forest.all_blocks()} == {
        (b.bid, b.level, b.owner) for b in ref.forest.all_blocks()
    }
    want = {b.bid: ref.spec.interior(b.data["pdf"]) for b in ref.forest.all_blocks()}
    for b in got.forest.all_blocks():
        np.testing.assert_array_equal(got.spec.interior(b.data["pdf"]), want[b.bid])


_PHYSICS = [(1.3, (0.05, 0.01, 0.0)), (1.6, (0.08, 0.0, 0.0)), (1.9, (0.0, 0.03, 0.01))]


@pytest.mark.gpu
@pytest.mark.parametrize("collision", ["bgk", "trt"])
@pytest.mark.parametrize("lattice", [D3Q19, D3Q27], ids=["d3q19", "d3q27"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_member_stencil_equals_solo_launches_on_card(dtype, lattice, collision):
    """One launch over M members' stacks with a shared mask equals M solo
    launches with each member's coefficients, bit for bit."""
    _require_card()
    rng = np.random.default_rng(31)
    B, shape = 4, (10, 12, 14)
    states = [_random_state(rng, B, lattice, shape, dtype) for _ in _PHYSICS]
    fd = torch.from_numpy(np.stack([f for f, _m in states])).cuda()
    md = torch.from_numpy(states[0][1]).cuda()
    mc = member_coeffs([o for o, _u in _PHYSICS], [u for _o, u in _PHYSICS], lattice=lattice,
                       collision=collision, dtype=fd.dtype, device="cuda")
    n0, m0 = lbm_stream_collide.launches, lbm_stream_collide.member_launches
    got = lbm_stream_collide(fd, md, members=mc)
    torch.cuda.synchronize()
    assert (lbm_stream_collide.launches, lbm_stream_collide.member_launches) == (n0 + 1, m0 + 1)
    for m, (omega, u_wall) in enumerate(_PHYSICS):
        want = lbm_stream_collide(fd[m], md, omega=omega, u_wall=u_wall, lattice=lattice, collision=collision)
        torch.testing.assert_close(got[m], want, rtol=0, atol=0)
    plain = lbm_stream_collide(fd.cpu(), md.cpu(), members=member_coeffs(
        [o for o, _u in _PHYSICS], [u for _o, u in _PHYSICS], lattice=lattice, collision=collision, dtype=fd.dtype))
    torch.testing.assert_close(got.cpu(), plain, **TOL[dtype])


@pytest.mark.gpu
def test_member_stencil_chunks_grid_z_on_card():
    """More than 65,535 blocks over two members: the launch chunks grid z,
    and a chunk's blocks still find their member and mask block."""
    _require_card()
    rng = np.random.default_rng(4)
    B, shape = 35_000, (3, 2, 2)
    states = [_random_state(rng, B, D3Q19, shape, np.float32) for _ in range(2)]
    fd = torch.from_numpy(np.stack([f for f, _m in states])).cuda()
    md = torch.from_numpy(states[0][1]).cuda()
    physics = _PHYSICS[:2]
    mc = member_coeffs([o for o, _u in physics], [u for _o, u in physics], collision="trt",
                       dtype=torch.float32, device="cuda")
    got = lbm_stream_collide(fd, md, members=mc)
    for m, (omega, u_wall) in enumerate(physics):
        want = lbm_stream_collide(fd[m], md, omega=omega, u_wall=u_wall, collision="trt")
        torch.testing.assert_close(got[m], want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("lattice", [D3Q19, D3Q27], ids=["d3q19", "d3q27"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_member_fill_equals_solo_launches_on_card(lattice, dtype):
    """Every segment of every branch of a three-level forest, filled for M
    members in one launch, equals M solo launches bit for bit."""
    _require_card()
    forest, reg, arena = refined_forest(cells=(6, 4, 8))
    index = {l: i for i, l in enumerate(arena.levels())}
    rng = np.random.default_rng(6)
    M = 3
    per_member = [random_buffers(rng, arena, lattice.Q, dtype, device="cuda") for _ in range(M)]
    bufs = [torch.stack(s) for s in zip(*per_member)]
    kinds = set()
    for fills in branch_fills(forest, reg, {l: arena.slots(l) for l in arena.levels()}):
        for l, fill in fills.items():
            for t in fill_tables(fill, index, "cuda"):
                kinds.add(t.kind)
                args = (t.kind, t.dst_slot, t.dst_cell, t.src_slot, t.src_cell)
                got = bufs[index[l]].clone()
                n0 = lbm_halo_fill.launches
                lbm_halo_fill(got, got if t.src == index[l] else bufs[t.src], *args)
                torch.cuda.synchronize()
                assert lbm_halo_fill.launches == n0 + 1
                for m in range(M):
                    want = bufs[index[l]][m].clone()
                    lbm_halo_fill(want, want if t.src == index[l] else bufs[t.src][m], *args)
                    torch.testing.assert_close(got[m], want, rtol=0, atol=0)
    assert kinds == {"same", "coarse", "fine"}
    assert lbm_halo_fill.kind_launches["copy+members"] > 0 and lbm_halo_fill.kind_launches["fine+members"] > 0


def _fill_then_stencil(f, mask, tables, sources, **kw):
    """Today's two launches: the fill kernel into a clone, then the stencil."""
    g = f.clone()
    for t in tables:
        lbm_halo_fill(g, sources[t.src], t.kind, t.dst_slot, t.dst_cell, t.src_slot, t.src_cell)
    return lbm_stream_collide(g, mask, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("collision", ["bgk", "trt"])
@pytest.mark.parametrize("lattice", [D3Q19, D3Q27], ids=["d3q19", "d3q27"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_halo_route_matches_fill_then_stencil_on_card(dtype, lattice, collision):
    """Every level fill of every branch of a three-level forest (same,
    coarse and fine rows), walls and a lid in the ghost ring: the halo route
    equals the fill kernel then the stencil kernel bitwise over the whole
    buffer, ghost ring included, solo and over M members (and those M solo
    launches), and its plain version within the
    stencil's tolerance (the plain stencil sums moments in another order)."""
    _require_card()
    forest, reg, arena = refined_forest(cells=(6, 4, 8))
    index = {l: i for i, l in enumerate(arena.levels())}
    rng = np.random.default_rng(9)
    bufs = tuple(random_buffers(rng, arena, lattice.Q, dtype, device="cuda"))
    M = len(_PHYSICS)
    stacks = tuple(torch.stack([b * (1 + 1e-3 * m) for m in range(M)]) for b in bufs)
    kw = dict(omega=1.4, lattice=lattice, collision=collision, u_wall=(0.05, 0.01, 0.0))
    mc = member_coeffs([o for o, _u in _PHYSICS], [u for _o, u in _PHYSICS], lattice=lattice,
                       collision=collision, dtype=bufs[0].dtype, device="cuda")
    kinds = set()
    for fills in branch_fills(forest, reg, {l: arena.slots(l) for l in arena.levels()}):
        for l, fill in fills.items():
            i = index[l]
            f = bufs[i]
            mask = torch.from_numpy((rng.random((f.shape[0], *f.shape[2:])) < 0.08).astype(np.int32))
            mask[:, :, :, -1] = CT_LID
            mask = mask.cuda()
            tables = fill_tables(fill, index, "cuda")
            kinds |= {t.kind for t in tables}
            hm = halo_map(tables, mask, lattice.Q)
            want = _fill_then_stencil(f, mask, tables, bufs, **kw)
            want_m = _fill_then_stencil(stacks[i], mask, tables, stacks, members=mc)
            n0 = (lbm_stream_collide.halo_launches, lbm_stream_collide.halo_member_launches)
            got = lbm_stream_collide(f, mask, halo=hm, sources=bufs, **kw)
            got_m = lbm_stream_collide(stacks[i], mask, members=mc, halo=hm, sources=stacks)
            torch.cuda.synchronize()
            assert (lbm_stream_collide.halo_launches, lbm_stream_collide.halo_member_launches) == (
                n0[0] + 2, n0[1] + 1)
            torch.testing.assert_close(got, want, rtol=0, atol=0)
            torch.testing.assert_close(got_m, want_m, rtol=0, atol=0)
            for m, (omega, u_wall) in enumerate(_PHYSICS):
                solo = lbm_stream_collide(stacks[i][m], mask, halo=hm, sources=tuple(s[m] for s in stacks),
                                          omega=omega, u_wall=u_wall, lattice=lattice, collision=collision)
                torch.testing.assert_close(got_m[m], solo, rtol=0, atol=0)
            coeffs = collision_coeffs(1.4, lattice=lattice, u_wall=(0.05, 0.01, 0.0), collision=collision,
                                      dtype=dtype)
            plain = halo_stream_collide_ref(f, mask, coeffs, tables, bufs, lattice=lattice, collision=collision)
            torch.testing.assert_close(got, plain, **TOL[dtype])
    assert kinds == {"same", "coarse", "fine"}


@pytest.mark.gpu
def test_halo_member_grid_chunks_past_65535_blocks_on_card():
    """More than 65,535 groups of 8 blocks over M members, the last group
    short: the halo launch chunks grid z, and every chunk's blocks still
    find their member, mask block, map block and sources (a same-level fill
    from the next block's interior into each block's x = 0 face)."""
    _require_card()
    rng = np.random.default_rng(8)
    B, dims, M = 175_001, (3, 2, 3), len(_PHYSICS)
    X, Y, Z = dims
    n = X * Y * Z
    states = [_random_state(rng, B, D3Q19, dims, np.float32) for _ in range(M)]
    fd = torch.from_numpy(np.stack([f for f, _m in states])).cuda()
    md = torch.from_numpy(states[0][1]).cuda()
    face = np.array([(0 * Y + y) * Z + z for y in range(Y) for z in range(Z)], dtype=np.int32)
    inner = np.array([(1 * Y + 1) * Z + 1 + (k % 2) for k in range(face.size)], dtype=np.int32)
    slots = np.arange(B, dtype=np.int32)
    tables = (FillTable(0, "same", *(torch.as_tensor(a, device="cuda") for a in (
        np.repeat(slots, face.size), np.tile(face, B), np.repeat((slots + 1) % B, face.size), np.tile(inner, B)))),)
    hm = halo_map(tables, md, D3Q19.Q)
    mc = member_coeffs([o for o, _u in _PHYSICS], [u for _o, u in _PHYSICS], collision="trt",
                       dtype=torch.float32, device="cuda")
    assert M * B > 65_535 * 8 and M * B % 8
    got = lbm_stream_collide(fd, md, members=mc, halo=hm, sources=(fd,))
    want = _fill_then_stencil(fd, md, tables, (fd,), members=mc)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for m, (omega, u_wall) in enumerate(_PHYSICS):
        solo = lbm_stream_collide(fd[m], md, halo=hm, sources=(fd[m],), omega=omega, u_wall=u_wall, collision="trt")
        torch.testing.assert_close(got[m], solo, rtol=0, atol=0)


_RANK_BASE = dict(
    root_grid=(2, 2, 2), cells_per_block=(8, 8, 8), omega=1.5, u_lid=(0.08, 0.0, 0.0),
    max_level=1, refine_upper=0.03, refine_lower=0.004,
)


def _rank_cases():
    """Every rank substep with inbound messages of a 4-rank ``BASE`` run
    (stepped on the CPU) past its first AMR event: (messages, local plan,
    level index, active levels, host masks, pdf stack shapes) a case."""
    from repro_torch.lbm.halo import compile_rank_halo_plan

    sim = AMRLBM(LidDrivenCavityConfig(nranks=4, stepping_mode="fused_sharded", device="cpu", **_RANK_BASE))
    sim.advance(4)
    sim.adapt()
    levels = sorted(sim.forest.levels_in_use())
    per_rank = sim.engine.arenas.per_rank
    rank_slots = {r: {l: per_rank[r].slots(l) for l in per_rank[r].levels()} for r in range(4) if per_rank[r].levels()}
    out = []
    for p in range(levels[-1] + 1):
        active = {l for l in levels if l >= levels[-1] - p}
        plan = compile_rank_halo_plan(sim.forest, sim.fields, rank_slots, fields=("pdf",), levels=active)
        for r in rank_slots:
            rl = per_rank[r].levels()
            recvs = [m for m in plan.messages if m.dst_rank == r]
            if recvs and active & set(rl):
                out.append((recvs, plan.local.get(r), {l: i for i, l in enumerate(rl)}, active & set(rl),
                            {l: np.array(per_rank[r].buffer(l, "mask")) for l in rl},
                            {l: per_rank[r].buffer(l, "pdf").shape[2:] for l in rl}))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("lattice", [D3Q19, D3Q27], ids=["d3q19", "d3q27"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_rank_halo_route_matches_fills_then_stencil_on_card(dtype, lattice):
    """A rank's levels of every pattern of a 4-rank run, random pdfs and
    payloads: the route through the payload segments alone equals the
    ``values`` fills then the stencil; the route over a slot list (the
    boundary half's list in neighbour order, and that list reversed) equals
    the whole-stack route on the listed blocks and leaves the others as
    ``out`` had them; the rank absorb with a halo stepper factory (unsplit,
    over its full-length list in neighbour order, and its split halves over
    theirs) equals its factory-less form (fills, then stencils). All
    bitwise."""
    from repro_torch.kernels.lbm_collide import ops

    _require_card()
    rng = np.random.default_rng(23)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    phys = dict(omega=1.4, lattice=lattice, collision="trt", u_wall=(0.05, 0.01, 0.0))
    payload_levels = slot_routes = 0
    for recvs, local, index, active, masks_np, dims in _rank_cases():
        levels = sorted(index, key=index.get)
        pdfs = tuple(torch.as_tensor(0.05 + 0.01 * rng.standard_normal((masks_np[l].shape[0], lattice.Q, *dims[l])),
                                     dtype=tdtype, device="cuda") for l in levels)
        msgs = tuple(torch.as_tensor(0.05 + 0.01 * rng.standard_normal((m.num_cells, lattice.Q)), dtype=tdtype,
                                     device="cuda") for m in recvs)
        sources = (*pdfs, *msgs)
        masks = {l: torch.from_numpy(masks_np[l]).cuda() for l in levels}
        kw = dict(steppers={l: ops.make_stream_collide(**phys) for l in levels}, masks=masks, active_levels=active,
                  device="cuda")
        factory = lambda l, fill, idx, messages=(): ops.make_halo_stream_collide(  # noqa: E731
            fill, idx, messages=messages, mask=masks[l], device="cuda", **phys)
        want = ops.make_rank_absorb(recvs, local, index, **kw)(tuple(t.clone() for t in pdfs), msgs)
        absorb = ops.make_rank_absorb(recvs, local, index, halo_stepper_factory=factory, **kw)
        interior, boundary = ops.make_rank_absorb_split(recvs, local, index, halo_stepper_factory=factory, **kw)
        assert set(absorb.slot_lists) == set(absorb.halo) and absorb.halo
        for l, lst in absorb.slot_lists.items():
            assert sorted(lst.tolist()) == list(range(masks[l].shape[0]))
        n0 = lbm_halo_fill.launches
        got = absorb(tuple(t.clone() for t in pdfs), msgs)
        halves = boundary(interior(tuple(t.clone() for t in pdfs)), msgs)
        torch.cuda.synchronize()
        assert lbm_halo_fill.launches == n0
        for a, b, c in zip(got, halves, want):
            torch.testing.assert_close(a, c, rtol=0, atol=0)
            torch.testing.assert_close(b, c, rtol=0, atol=0)
        fills, inbound = ops._rank_rows(recvs, local, index, masks, active)
        for l, rows in inbound.items():
            i = index[l]
            # the payload segments alone, against the values fills then the stencil
            hm = halo_map(ops.message_tables(rows, len(levels), "cuda"), masks[l], lattice.Q)
            g = pdfs[i].clone()
            for mi, db, dc, off, n in rows:
                lbm_halo_fill(g, msgs[mi][off : off + n], "values", torch.as_tensor(db, dtype=torch.int32).cuda(),
                              torch.as_tensor(dc, dtype=torch.int32).cuda())
            torch.testing.assert_close(lbm_stream_collide(pdfs[i], masks[l], halo=hm, sources=sources, **phys),
                                       lbm_stream_collide(g, masks[l], **phys), rtol=0, atol=0)
            payload_levels += 1
            # local and message rows over the boundary slot list
            tables = (ops.fill_tables(fills[l], index, "cuda") if l in fills else ()) + ops.message_tables(
                rows, len(levels), "cuda")
            hm = halo_map(tables, masks[l], lattice.Q)
            listed = sorted({int(s) for _mi, db, *_r in rows for s in np.unique(db)})
            order = boundary.slot_lists[l]
            assert sorted(order.tolist()) == listed
            whole = lbm_stream_collide(pdfs[i], masks[l], halo=hm, sources=sources, **phys)
            rest = [b for b in range(pdfs[i].shape[0]) if b not in listed]
            for lst in (order, order[::-1].copy()):
                slots = torch.as_tensor(lst, device="cuda")
                sentinel = torch.full_like(pdfs[i], -7.0)
                out = sentinel.clone()
                n1 = lbm_stream_collide.halo_slot_launches
                lbm_stream_collide(pdfs[i], masks[l], halo=hm, sources=sources, slots=slots, out=out, **phys)
                torch.cuda.synchronize()
                assert lbm_stream_collide.halo_slot_launches == n1 + 1
                torch.testing.assert_close(out[slots.long()], whole[slots.long()], rtol=0, atol=0)
                torch.testing.assert_close(out[rest], sentinel[rest], rtol=0, atol=0)
                slot_routes += 1
    assert payload_levels > 0 and slot_routes > 0


@pytest.mark.gpu
def test_service_batch_equals_solo_fused_runs_on_card():
    """Four jobs of different physics, batched by the service on the
    kernels, split at the AMR event and end bitwise equal to solo ``fused``
    runs of their configs."""
    _require_card()
    base = dict(
        root_grid=(2, 2, 2), cells_per_block=(8, 8, 8), max_level=1, refine_upper=0.03,
        refine_lower=0.004, kernel_backend="cuda",
    )
    members = [dict(omega=1.5, u_lid=(0.08, 0.0, 0.0)), dict(omega=1.7, u_lid=(0.06, 0.0, 0.0)),
               dict(omega=1.6, u_lid=(0.08, 0.02, 0.0)), dict(omega=1.9, u_lid=(0.05, 0.0, 0.0))]
    svc = SimulationService()
    ids = [svc.submit(JobSpec(config=LidDrivenCavityConfig(stepping_mode="arena", **base, **m),
                              coarse_steps=8, amr_interval=4)) for m in members]
    m0 = lbm_stream_collide.member_launches
    svc.run()
    s = svc.summary()
    assert s["ensembles_formed"] == 1 and s["divergence_splits"] >= 1 and s["compile_misses"] <= 2
    assert lbm_stream_collide.member_launches > m0
    for jid, m in zip(ids, members):
        sim = svc.jobs[jid].sim
        assert sim.device.type == "cuda"
        ref = AMRLBM(LidDrivenCavityConfig(stepping_mode="fused", **base, **m))
        ref.run(8, amr_interval=4)
        ref.materialize_host()
        assert {(b.bid, b.level) for b in sim.forest.all_blocks()} == {(b.bid, b.level) for b in ref.forest.all_blocks()}
        want = {b.bid: b.data["pdf"] for b in ref.forest.all_blocks()}
        for b in sim.forest.all_blocks():
            np.testing.assert_array_equal(sim.spec.interior(b.data["pdf"]), ref.spec.interior(want[b.bid]))


_BASE4 = dict(
    root_grid=(2, 2, 2), cells_per_block=(8, 8, 8), omega=1.5, u_lid=(0.08, 0.0, 0.0),
    max_level=1, refine_upper=0.03, refine_lower=0.004, nranks=4, kernel_backend="cuda",
)


def _assert_runs_bitwise(got, ref):
    assert {(b.bid, b.level, b.owner) for b in got.forest.all_blocks()} == {
        (b.bid, b.level, b.owner) for b in ref.forest.all_blocks()
    }
    want = {b.bid: ref.spec.interior(b.data["pdf"]) for b in ref.forest.all_blocks()}
    for b in got.forest.all_blocks():
        np.testing.assert_array_equal(got.spec.interior(b.data["pdf"]), want[b.bid])


def _run_on_card(mode, **over):
    sim = AMRLBM(LidDrivenCavityConfig(stepping_mode=mode, **_BASE4, **over))
    sim.run(8, amr_interval=4)
    sim.materialize_host()
    return sim


@pytest.mark.gpu
def test_device_sharded_on_one_card_matches_fused_bitwise_on_card():
    """Four ranks that share the card (``rank_devices=("cuda:0",) * 4``):
    payloads move by on-device copies, the stacks are padded, each rank
    reads its payloads through the stencil's halo route with no fill
    launch, and every block's interior ends with ``fused``'s bits."""
    _require_card()
    n0 = (lbm_stream_collide.halo_launches, lbm_halo_fill.launches)
    got = _run_on_card("device_sharded", rank_devices=("cuda:0",) * 4)
    assert got.engine.rank_devices == (torch.device("cuda:0"),) * 4
    assert lbm_stream_collide.halo_launches > n0[0] and lbm_halo_fill.launches == n0[1]
    assert got.comm.ppermute_rounds > 0
    _assert_runs_bitwise(got, _run_on_card("fused"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_stencil_leaves_an_all_wall_weight_slot_unchanged_on_card(dtype):
    """A device_sharded pad slot (weight pdfs under an all-WALL mask) comes
    out of the CUDA stencil bitwise unchanged, beside real blocks."""
    _require_card()
    rng = np.random.default_rng(5)
    f, mask = _random_state(rng, 3, D3Q19, (10, 10, 10), dtype)
    w = np.broadcast_to(np.asarray(D3Q19.w, dtype)[None, :, None, None, None], (2, 19, 10, 10, 10))
    fd = torch.from_numpy(np.concatenate([f, w])).cuda()
    md = torch.from_numpy(np.concatenate([mask, np.full((2, 10, 10, 10), CT_WALL, np.int32)])).cuda()
    kw = dict(omega=1.4, lattice=D3Q19, collision="trt", u_wall=(0.05, 0.01, 0.0))
    got = lbm_stream_collide(fd, md, **kw)
    real = lbm_stream_collide(fd[:3].contiguous(), md[:3].contiguous(), **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[3:], fd[3:], rtol=0, atol=0)
    torch.testing.assert_close(got[:3], real, rtol=0, atol=0)


@pytest.mark.gpu
def test_kernels_and_device_sharded_on_a_second_card_on_card():
    """Tensors on ``cuda:1`` while ``cuda:0`` is current: each wrapper
    launches into its operand's card, and ``device_sharded`` with ranks on
    two cards (peer copies) ends bitwise ``fused``'s. Needs two cards."""
    _require_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.set_device(0)
    rng = np.random.default_rng(9)
    f, mask = _random_state(rng, 3, D3Q19, (10, 12, 14), np.float32)
    kw = dict(omega=1.4, lattice=D3Q19, collision="trt", u_wall=(0.05, 0.01, 0.0))
    f1, m1 = torch.from_numpy(f).to("cuda:1"), torch.from_numpy(mask).to("cuda:1")
    got = lbm_stream_collide(f1, m1, **kw)
    torch.cuda.synchronize(1)
    assert got.device == torch.device("cuda:1")
    torch.testing.assert_close(got.cpu(), stream_collide_ref(f1.cpu(), m1.cpu(), **kw), **TOL[np.float32])
    seg = torch.from_numpy(rng.standard_normal((4, 19)).astype(np.float32))
    ds, dc = torch.tensor([0, 1, 2, 2], dtype=torch.int32), torch.tensor([0, 5, 7, 9], dtype=torch.int32)
    want = torch.from_numpy(f).clone()
    halo_fill_ref(want, seg, "values", ds, dc)
    lbm_halo_fill(f1, seg.to("cuda:1"), "values", ds.to("cuda:1"), dc.to("cuda:1"))
    torch.cuda.synchronize(1)
    torch.testing.assert_close(f1.cpu(), want, rtol=0, atol=0)
    got = _run_on_card("device_sharded", rank_devices=("cuda:0", "cuda:1", "cuda:0", "cuda:1"))
    assert {d.index for d in got.engine.rank_devices} == {0, 1}
    _assert_runs_bitwise(got, _run_on_card("fused"))


@pytest.mark.gpu
def test_reduced_qwen2_card_matches_cpu_on_card():
    """The reduced qwen2-0.5b from one seed on the card and on the CPU: f32
    logits and 6 decode steps within the CPU tests' f32 tolerance (rtol /
    atol 1e-5, TF32 off), the same greedy tokens, and a decode step that
    makes no host sync."""
    _require_card()
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config("qwen2-0.5b").reduced()
    models = {d: build_model(cfg, device=d, generator=torch.Generator().manual_seed(0)) for d in ("cpu", "cuda")}
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (3, 12)))
    want = models["cpu"].logits({"tokens": toks})
    got = models["cuda"].logits({"tokens": toks.cuda()})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    caches = {d: m.init_cache(3, 8) for d, m in models.items()}
    for t in range(6):
        logits = {}
        for d, m in models.items():
            tok = toks[:, t : t + 1]
            logits[d], caches[d] = m.decode(tok.cuda() if d == "cuda" else tok, caches[d])
        torch.testing.assert_close(logits["cuda"].cpu(), logits["cpu"], rtol=1e-5, atol=1e-5)
    caches = {d: m.init_cache(3, 8) for d, m in models.items()}
    steps = {d: make_serve_step(m) for d, m in models.items()}
    tok = {"cpu": toks[:, :1].to(torch.int32), "cuda": toks[:, :1].to(torch.int32).cuda()}
    for t in range(6):
        tok["cpu"], caches["cpu"] = steps["cpu"](tok["cpu"], caches["cpu"])
        if t == 5:
            torch.cuda.set_sync_debug_mode("error")
        try:
            tok["cuda"], caches["cuda"] = steps["cuda"](tok["cuda"], caches["cuda"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(tok["cuda"].cpu(), tok["cpu"])


# the reduced moe, ssm, hybrid and audio archs: the card and the CPU in
# float64, where reduction order costs about 1e-15 relative
FAMILY_ARCHS = ["granite-moe-1b-a400m", "rwkv6-3b", "zamba2-2.7b", "whisper-small"]
F64_REL = 1e-9


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_reduced_family_card_matches_cpu_in_f64_on_card(arch):
    """One seed's weights in float64 on the card and on the CPU, over 150
    tokens (across rwkv6's 64-token and mamba2's 128-token chunks): logits
    and 6 decode steps within ``1e-9 * max|logits|``, moe routes equal in
    every layer, the same greedy tokens, and a decode step that makes no
    host sync."""
    _require_card()
    cfg = get_config(arch).reduced()
    drawn = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    models = {}
    for d in ("cpu", "cuda"):
        models[d] = build_model(cfg, device=d, dtype=torch.float64)
        models[d].load_state_dict(drawn.state_dict())
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 150)))
    batch = {"tokens": toks}
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = torch.from_numpy(0.5 * rng.standard_normal((2, cfg.encoder_len, cfg.d_model)))
    moe_layers = {d: [l for l in m.layers if hasattr(l, "moe")] for d, m in models.items()}
    for layers in moe_layers.values():
        for layer in layers:
            layer.routes = []
    want = models["cpu"].logits(batch)
    got = models["cuda"].logits({k: v.cuda() for k, v in batch.items()}).cpu()
    bound = F64_REL * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=bound)
    for lc, lg in zip(moe_layers["cpu"], moe_layers["cuda"]):
        assert torch.equal(lg.routes[0].cpu(), lc.routes[0])
        lc.routes = lg.routes = None
    caches = {}
    for d, m in models.items():
        caches[d] = m.init_cache(2, 8, torch.float64)
        if cfg.is_encoder_decoder:
            m.fill_cross_cache(caches[d], batch["enc_embeds"].to(d))
    tok = {"cpu": toks[:, :1].to(torch.int32), "cuda": toks[:, :1].to(torch.int32).cuda()}
    for t in range(5):
        logits = {}
        for d, m in models.items():
            logits[d], caches[d] = m.decode(tok[d], caches[d])
            tok[d] = logits[d][:, -1:].argmax(dim=-1).to(torch.int32)
        torch.testing.assert_close(logits["cuda"].cpu(), logits["cpu"], rtol=0, atol=bound)
        assert torch.equal(tok["cuda"].cpu(), tok["cpu"])
    steps = {d: make_serve_step(m) for d, m in models.items()}
    tok["cpu"], caches["cpu"] = steps["cpu"](tok["cpu"], caches["cpu"])
    torch.cuda.set_sync_debug_mode("error")
    try:
        tok["cuda"], caches["cuda"] = steps["cuda"](tok["cuda"], caches["cuda"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(tok["cuda"].cpu(), tok["cpu"])


# the reduced dense, moe, ssm, hybrid and audio archs for the training legs
TRAIN_ARCHS = ["qwen2-0.5b", *FAMILY_ARCHS]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_reduced_train_step_card_matches_cpu_in_f64_on_card(arch):
    """One seed's weights in float64 on the card and on the CPU, 2 x 150
    tokens: ``Model.loss`` and every gradient (remat on) within ``1e-9 *
    max|g|`` of the leaf, the same leaves without a gradient; then one
    ``make_train_step`` step of 2 microbatches each: loss and grad norm
    within ``1e-9`` relative."""
    _require_card()
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step

    cfg = get_config(arch).reduced()
    drawn = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 150))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 150)))}
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = torch.from_numpy(0.5 * rng.standard_normal((2, cfg.encoder_len, cfg.d_model)))
    models, losses, batches = {}, {}, {}
    for d in ("cpu", "cuda"):
        models[d] = build_model(cfg, device=d, dtype=torch.float64)
        models[d].load_state_dict(drawn.state_dict())
        batches[d] = {k: v.to(d) for k, v in batch.items()}
        loss, _ = models[d].loss(batches[d])
        loss.backward()
        losses[d] = float(loss.detach())
    assert abs(losses["cuda"] - losses["cpu"]) <= F64_REL * abs(losses["cpu"])
    for (name, pc), pg in zip(models["cpu"].named_parameters(), models["cuda"].parameters()):
        assert (pc.grad is None) == (pg.grad is None), name
        if pc.grad is not None:
            bound = F64_REL * float(pc.grad.abs().max())
            torch.testing.assert_close(pg.grad.cpu(), pc.grad, rtol=0, atol=bound, msg=name)
    metrics = {}
    for d, model in models.items():
        _, m = make_train_step(model, AdamWConfig(), microbatches=2)(adamw_init(model), batches[d])
        metrics[d] = {k: float(v) for k, v in m.items()}
    for k in ("loss", "grad_norm", "lr"):
        assert abs(metrics["cuda"][k] - metrics["cpu"][k]) <= F64_REL * abs(metrics["cpu"][k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_makes_no_host_sync_on_card(microbatches):
    """The reduced granite-moe (the moe dispatch, remat, the chunked loss)
    in f32 on the card: after a warm step, one ``make_train_step`` step
    under ``torch.cuda.set_sync_debug_mode("error")``; its loss finite."""
    _require_card()
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step

    cfg = get_config("granite-moe-1b-a400m").reduced()
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 40))).cuda() for k in ("tokens", "labels")}
    step = make_train_step(model, AdamWConfig(), microbatches=microbatches)
    opt, _ = step(adamw_init(model), batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        opt, metrics = step(opt, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(opt["step"]) == 2 and bool(torch.isfinite(metrics["loss"]))
