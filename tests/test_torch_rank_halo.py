"""The rank paths' halo route on the CPU: a rank's local rows and its inbound
message rows read through one map by ``make_rank_absorb`` and
``make_rank_absorb_split`` with a halo stepper factory.

On the conformance suite's ``BASE`` scenario past its first AMR event (two
levels in use), at 1, 4 and 13 ranks, for every rank and activity pattern
of the ``fused_sharded`` engine's rank plans, with random pdfs and payloads
made from a seed with numpy:

* (a) a rank level's map names each local row and each message row once,
  at its target; a message row is a ``"values"`` row at offset row * Q of
  its payload, whose Q values are adjacent (direction stride 1);
* (b) the halo form (the ``cuda`` backend, on CPU tensors the plain
  version through the map, :func:`~repro_torch.kernels.lbm_collide.ref.halo_stream_collide_ref`)
  equals the fills then the stencil bitwise, unsplit and split; so does
  the ``ref`` backend's halo form;
* (c) the port's halo form matches the JAX package's ``make_rank_absorb``
  with its ``halo_stepper_factory`` on its ``ref`` backend within the
  tolerance of ``tests/test_kernels_lbm.py`` (f32 rtol 3e-5 / atol 3e-6:
  the frameworks sum moments in different orders; f64 1e-12);
* (d) the route's operand checks refuse a payload of the wrong shape or
  dtype, a payload on a member stack, more segments than the maximum, and
  an interior half whose blocks name a payload row;
* (e) the route's slot lists (the ``cuda`` backend's neighbour order): each
  half's list, and the unsplit level's full-length list, is a permutation
  of its blocks, and every octet of siblings that a list holds whole is one
  of its launch groups; the split absorb over those lists equals the
  unsplit absorb and the factory-less form bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lbm_collide import ops as jops
from repro_torch.kernels.lbm_collide import ops
from repro_torch.kernels.lbm_collide.lbm_collide import (
    HALO_MAX_SEGMENTS,
    HALO_SEG_SHIFT,
    HaloMap,
    lbm_stream_collide,
    member_coeffs,
)
from repro_torch.core.blockid import parent_id
from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
from repro_torch.lbm.halo import compile_rank_halo_plan

BASE = dict(
    root_grid=(2, 2, 2),
    cells_per_block=(8, 8, 8),
    omega=1.5,
    u_lid=(0.08, 0.0, 0.0),
    max_level=1,
    refine_upper=0.03,
    refine_lower=0.004,
)
PHYS = dict(omega=1.5, u_wall=(0.08, 0.0, 0.0), collision="trt")
TOL = {np.float32: dict(rtol=3e-5, atol=3e-6), np.float64: dict(rtol=1e-12, atol=1e-12)}
RANKS = [1, 4, 13]
DTYPES = [np.float32, np.float64]
OFF_MASK = (1 << 56) - 1


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One PyTorch intra-op thread a worker process (see
    ``tests/test_torch_sharded.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass
class RankCase:
    """One rank's substep of one activity pattern."""

    rank: int
    pattern: int
    levels: tuple
    index: dict
    recvs: list
    local: object
    active: set
    masks: dict  # level -> host (B, X, Y, Z) int32
    shapes: dict  # level -> pdf stack shape
    parents: dict  # level -> the parent id of each slot's block


@pytest.fixture(scope="module")
def cases():
    """nranks -> the :class:`RankCase` of every rank that steps in a
    pattern, from the ``fused_sharded`` engine's state past its first AMR
    event."""
    cache = {}

    def get(nranks):
        if nranks not in cache:
            sim = AMRLBM(LidDrivenCavityConfig(nranks=nranks, stepping_mode="fused_sharded", device="cpu", **BASE))
            sim.advance(4)
            sim.adapt()
            levels = sorted(sim.forest.levels_in_use())
            assert len(levels) == 2
            per_rank = sim.engine.arenas.per_rank
            ranks = [r for r in range(nranks) if per_rank[r].levels()]
            rank_slots = {r: {l: per_rank[r].slots(l) for l in per_rank[r].levels()} for r in ranks}
            out = []
            for p in range(levels[-1] + 1):
                active = {l for l in levels if l >= levels[-1] - p}
                plan = compile_rank_halo_plan(sim.forest, sim.fields, rank_slots, fields=("pdf",), levels=active)
                for r in ranks:
                    rl = tuple(per_rank[r].levels())
                    if not active & set(rl):
                        continue
                    out.append(RankCase(
                        r, p, rl, {l: i for i, l in enumerate(rl)}, [m for m in plan.messages if m.dst_rank == r],
                        plan.local.get(r), active & set(rl),
                        {l: np.array(per_rank[r].buffer(l, "mask")) for l in rl},
                        {l: per_rank[r].buffer(l, "pdf").shape for l in rl},
                        {l: np.array([parent_id(b) for b in sorted(per_rank[r].slots(l), key=per_rank[r].slots(l).get)])
                         for l in rl},
                    ))
            cache[nranks] = out
        return cache[nranks]

    return get


def _inputs(case: RankCase, dtype, seed: int):
    """Random pdfs (one stack a rank level) and payloads (one a message)."""
    rng = np.random.default_rng(seed)
    pdfs = [(0.05 + 0.01 * rng.standard_normal(case.shapes[l])).astype(dtype) for l in case.levels]
    msgs = [(0.05 + 0.01 * rng.standard_normal((m.num_cells, 19))).astype(dtype) for m in case.recvs]
    return pdfs, msgs


def _port_kw(case: RankCase, backend: str) -> dict:
    return dict(
        steppers={l: ops.make_stream_collide(backend=backend, **PHYS) for l in case.levels},
        masks={l: torch.from_numpy(case.masks[l]) for l in case.levels},
        active_levels=case.active,
        backend=backend,
        device="cpu",
    )


def _factory(case: RankCase, backend: str):
    def factory(level, fill, level_index, messages=()):
        return ops.make_halo_stream_collide(fill, level_index, messages=messages, mask=case.masks[level],
                                            backend=backend, device="cpu", **PHYS)

    return factory


def _t(arrays) -> tuple:
    return tuple(torch.from_numpy(a.copy()) for a in arrays)


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("nranks", RANKS)
def test_rank_map_names_each_local_and_message_row_once(cases, nranks):
    seen_messages = 0
    for case in cases(nranks):
        fills, inbound = ops._rank_rows(case.recvs, case.local, case.index, case.masks, case.active)
        for l in case.active:
            if l not in fills and l not in inbound:
                continue
            local = ops.fill_tables(fills[l], case.index, "cpu") if l in fills else ()
            msg = ops.message_tables(inbound.get(l, ()), len(case.levels), "cpu")
            tables = local + msg
            assert len(tables) <= HALO_MAX_SEGMENTS
            mask = torch.from_numpy(case.masks[l])
            cells = ops.halo_map(tables, mask, 19).cells.view(mask.shape[0], -1)
            rows = sum(t.dst_slot.numel() for t in tables)
            assert int((cells >= 0).sum()) == rows  # every row once: targets are unique
            for k, t in enumerate(tables):
                e = cells[t.dst_slot.long(), t.dst_cell.long()]
                assert bool((e >> HALO_SEG_SHIFT == k).all())
            # message rows: one values table a payload, offset row * Q
            for t in msg:
                assert t.kind == "values" and t.src_slot is None
                assert len(case.levels) <= t.src < len(case.levels) + len(case.recvs)
                e = cells[t.dst_slot.long(), t.dst_cell.long()]
                torch.testing.assert_close(e & OFF_MASK, t.src_cell.long() * 19, rtol=0, atol=0)
            for mi, db, dc, off, n in inbound.get(l, ()):
                e = cells[torch.as_tensor(db, dtype=torch.long), torch.as_tensor(dc, dtype=torch.long)]
                assert bool((e >> HALO_SEG_SHIFT == len(local) + [t.src for t in msg].index(len(case.levels) + mi)).all())
                np.testing.assert_array_equal((e & OFF_MASK).numpy(), (off + np.arange(n)) * 19)
                seen_messages += 1
            # a payload row's value of direction q is element offset + q
            for t in msg:
                payload = torch.arange(t.rows * 19, dtype=torch.float64).view(t.rows, 19)
                e = cells[t.dst_slot.long(), t.dst_cell.long()] & OFF_MASK
                flat = payload.view(-1)
                for q in (0, 7, 18):
                    torch.testing.assert_close(flat[e + q], payload[t.src_cell.long(), q], rtol=0, atol=0)
    assert (seen_messages > 0) == (nranks > 1)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("nranks", RANKS)
def test_rank_halo_absorb_equals_fills_then_stencil_bitwise(cases, nranks, dtype):
    """Both backends' halo form against their fills-then-stencil form, for
    every rank and pattern; the split halves against the unsplit absorb
    wherever the rank has interior and boundary blocks."""
    split_seen = halo_seen = 0
    for i, case in enumerate(cases(nranks)):
        pdfs, msgs = _inputs(case, dtype, seed=i)
        for backend in ("cuda", "ref"):
            kw = _port_kw(case, backend)
            want = ops.make_rank_absorb(case.recvs, case.local, case.index, **kw)(_t(pdfs), _t(msgs))
            factory = _factory(case, backend)
            absorb = ops.make_rank_absorb(case.recvs, case.local, case.index, halo_stepper_factory=factory, **kw)
            assert absorb.fill_segments == 0
            halo_seen += absorb.halo_steps
            _assert_bitwise(absorb(_t(pdfs), _t(msgs)), want)
            # each level's halo step writes nothing but its output
            sources = (*_t(pdfs), *_t(msgs))
            for l, h in absorb.halo.items():
                h.step(sources[case.index[l]], h.fill(sources))
            _assert_bitwise(sources, (*_t(pdfs), *_t(msgs)))
            interior, boundary = ops.make_rank_absorb_split(case.recvs, case.local, case.index,
                                                            halo_stepper_factory=factory, **kw)
            _assert_bitwise(boundary(interior(_t(pdfs)), _t(msgs)), want)
            split_seen += bool(case.recvs and interior.halo_steps)
    assert halo_seen > 0
    assert (split_seen > 0) == (nranks == 4)  # at 13 ranks every block borders another rank


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("nranks", RANKS)
def test_rank_halo_absorb_matches_jax_halo_absorb(cases, nranks, dtype):
    checked = 0
    for i, case in enumerate(cases(nranks)):
        if not case.recvs and not (case.local and case.local.ops):
            continue
        pdfs, msgs = _inputs(case, dtype, seed=100 + i)
        absorb = ops.make_rank_absorb(case.recvs, case.local, case.index, halo_stepper_factory=_factory(case, "cuda"),
                                      **_port_kw(case, "cuda"))
        got = absorb(_t(pdfs), _t(msgs))
        with jax.enable_x64(dtype == np.float64):
            jabsorb = jops.make_rank_absorb(
                case.recvs, case.local, case.index,
                {l: jops.make_stream_collide(backend="ref", **PHYS) for l in case.levels},
                {l: jnp.asarray(case.masks[l]) for l in case.levels},
                case.active,
                donate=False,
                halo_stepper_factory=lambda l, db, dc, case=case: jops.make_halo_stream_collide(
                    db, dc, mask=case.masks[l], backend="ref", **PHYS),
            )
            want = [np.asarray(a) for a in jabsorb(tuple(map(jnp.asarray, pdfs)), tuple(map(jnp.asarray, msgs)))]
        for a, b in zip(got, want):
            assert b.dtype == dtype
            np.testing.assert_allclose(a.numpy(), b, **TOL[dtype])
        checked += 1
    assert checked > 0


def test_rank_halo_route_operand_checks(cases, monkeypatch):
    case = next(c for c in cases(4) if c.recvs and c.local and c.local.ops)
    fills, inbound = ops._rank_rows(case.recvs, case.local, case.index, case.masks, case.active)
    l = next(l for l in inbound if l in fills)
    i = case.index[l]
    pdfs, msgs = (list(x) for x in _inputs(case, np.float32, seed=7))
    local = ops.fill_tables(fills[l], case.index, "cpu")
    msg = ops.message_tables(inbound[l], len(case.levels), "cpu")
    mask = torch.from_numpy(case.masks[l])
    hm = ops.halo_map(local + msg, mask, 19)
    f = torch.from_numpy(pdfs[i])
    sources = (*_t(pdfs), *_t(msgs))
    lbm_stream_collide(f, mask, halo=hm, sources=sources, **PHYS)  # well formed
    t = msg[0]
    for bad, what in (
        (torch.zeros((t.rows, 20)), "payload"),  # Q + 1 directions
        (torch.zeros((t.rows - 1, 19)), "payload"),  # fewer rows than the map names
        (torch.zeros((t.rows, 19), dtype=torch.float64), "payload"),  # another dtype
        (torch.zeros((19, t.rows)).t(), "payload"),  # not contiguous
    ):
        doctored = list(sources)
        doctored[t.src] = bad
        with pytest.raises(ValueError, match=what):
            lbm_stream_collide(f, mask, halo=hm, sources=tuple(doctored), **PHYS)
    # a payload segment on a member stack
    mc = member_coeffs([1.5, 1.6], [(0.08, 0.0, 0.0)] * 2, collision="trt")
    stacks = tuple(torch.stack([s, s]) if s.dim() == 5 else s for s in sources)
    with pytest.raises(ValueError, match="member axis"):
        lbm_stream_collide(stacks[i], mask, members=mc, halo=hm, sources=stacks)
    # more segments than the maximum, at the route and at the map's build
    many = (local[0],) * (HALO_MAX_SEGMENTS + 1)
    with pytest.raises(ValueError, match="segments"):
        lbm_stream_collide(f, mask, halo=HaloMap(hm.cells, many, mask), sources=sources, **PHYS)
    with pytest.raises(ValueError, match="segments"):
        ops.halo_map(many, mask, 19)
    # an interior half whose blocks name a payload row
    monkeypatch.setattr(ops, "boundary_slot_sets", lambda messages, masks: {l: frozenset() for l in masks})
    with pytest.raises(AssertionError, match="names a payload row"):
        ops.make_rank_absorb_split(case.recvs, case.local, case.index, halo_stepper_factory=_factory(case, "cuda"),
                                   **_port_kw(case, "cuda"))


def _sibling_octets(parents: np.ndarray, listed) -> list[set]:
    """The octets of siblings (8 blocks of one parent) among ``listed``."""
    by_parent: dict[int, set] = {}
    for s in listed:
        by_parent.setdefault(int(parents[s]), set()).add(int(s))
    return [g for g in by_parent.values() if len(g) == 8]


@pytest.mark.parametrize("nranks", RANKS)
def test_rank_route_slot_lists_group_whole_octets(cases, nranks):
    """(e): the lists are permutations of their halves' blocks and hold
    each whole octet of siblings as one launch group; the split absorb over
    them equals the unsplit absorb and the factory-less form bitwise."""
    lists_seen = octets_seen = 0
    for i, case in enumerate(cases(nranks)):
        kw = _port_kw(case, "cuda")
        factory = _factory(case, "cuda")
        absorb = ops.make_rank_absorb(case.recvs, case.local, case.index, halo_stepper_factory=factory, **kw)
        interior, boundary = ops.make_rank_absorb_split(case.recvs, case.local, case.index,
                                                        halo_stepper_factory=factory, **kw)
        bnd = ops.boundary_slot_sets(case.recvs, case.masks)
        assert set(absorb.slot_lists) == set(absorb.halo)
        for l, h in absorb.halo.items():
            nblocks = case.masks[l].shape[0]
            b = set(bnd.get(l, ()))
            want = {"unsplit": set(range(nblocks)), "interior": set(range(nblocks)) - b, "boundary": b}
            got = {"unsplit": absorb.slot_lists.get(l), "interior": interior.slot_lists.get(l),
                   "boundary": boundary.slot_lists.get(l)}
            for name, lst in got.items():
                if not want[name]:
                    assert lst is None
                    continue
                assert lst.dtype == np.int32 and sorted(lst.tolist()) == sorted(want[name]), name
                groups = [set(lst[k : k + 8].tolist()) for k in range(0, lst.size, 8)]
                for octet in _sibling_octets(case.parents[l], want[name]):
                    assert octet in groups, (name, sorted(octet))
                    octets_seen += 1
                lists_seen += 1
        pdfs, msgs = _inputs(case, np.float32, seed=200 + i)
        want_out = ops.make_rank_absorb(case.recvs, case.local, case.index, **kw)(_t(pdfs), _t(msgs))
        _assert_bitwise(absorb(_t(pdfs), _t(msgs)), want_out)
        _assert_bitwise(boundary(interior(_t(pdfs)), _t(msgs)), want_out)
    assert lists_seen > 0
    assert (octets_seen > 0) == (nranks < 13)  # at 13 ranks no rank holds a whole octet


def test_neighbour_order_puts_cubes_then_z_neighbours_together():
    """A 2 x 2 x 4 column of blocks: labelled in Morton order (the two
    cubes' blocks consecutive), both cubes become launch groups, and a list
    whose first cube is broken keeps the second whole; labelled z fastest
    (x * 8 + y * 4 + z: no 8 consecutive blocks make a cube), a group grows
    along z first, then y, then x."""
    def neighbours(label):
        nbr: dict[int, dict[int, int]] = {}
        for x, y, z in np.ndindex(2, 2, 4):
            for axis, (dx, dy, dz) in enumerate(((1, 0, 0), (0, 1, 0), (0, 0, 1))):
                if x + dx < 2 and y + dy < 2 and z + dz < 4:
                    a, b = label(x, y, z), label(x + dx, y + dy, z + dz)
                    nbr.setdefault(a, {})[b] = axis
                    nbr.setdefault(b, {})[a] = axis
        return nbr

    morton = neighbours(lambda x, y, z: (z // 2) * 8 + x * 4 + y * 2 + z % 2)
    assert ops.cube_groups(range(16), morton) == 2
    np.testing.assert_array_equal(ops.neighbour_order(reversed(range(16)), morton), np.arange(16))
    broken = ops.neighbour_order(range(1, 16), morton)
    assert sorted(broken.tolist()) == list(range(1, 16))
    assert broken[:8].tolist() == list(range(8, 16)) and ops.cube_groups(broken, morton) == 1

    z_fastest = neighbours(lambda x, y, z: x * 8 + y * 4 + z)
    order = ops.neighbour_order(range(16), z_fastest)
    assert ops.cube_groups(range(16), z_fastest) == 0
    # the seed's z column, then its y neighbours' column; the x neighbours last
    assert order[:4].tolist() == [0, 1, 2, 3] and set(order[:8].tolist()) == set(range(8))
