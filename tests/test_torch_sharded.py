"""The port's rank-sharded engines (``sharded``, ``fused_sharded``) on the
conformance suite's ``BASE`` scenario (2^3 roots, 8^3 cells,
``max_level=1``, 8 coarse steps with AMR every 4).

* At 1, 4 and 13 ranks, both modes — and ``fused_sharded`` with the split
  and the unsplit absorb, on both backends — equal the port's ``restack``
  at the same rank count **bitwise** (same forest, interiors, mass): the
  kernels are block-local and fixed-order, so how blocks are grouped into
  stacks cannot change a bit.
* They match the JAX package's ``restack`` (``kernel_backend="ref"``): the
  same forest after each AMR event, interior density and velocity within
  the f32 kernel tolerance (rtol 3e-5 / atol 3e-6: the frameworks sum
  moments in different orders), mass within 1e-6 relative.
* On the ``cuda`` backend the engines' rank absorbs launch no fill and
  gather or scatter nothing: a level with rows, local or inbound, is one
  launch of the stencil's halo route (a half's, over its slot list, in the
  split), which reads each message row from the received payload. The
  absorb built without a halo stepper factory fills every ghost cell with
  the fill kernel (inbound messages through its ``"values"`` kind) before
  any stencil.
* Between AMR events ``fused_sharded`` moves nothing between host and
  device, and its ``Comm`` traffic equals the host-sharded mode's.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.lbm import AMRLBM as JaxAMRLBM
from repro.lbm import LidDrivenCavityConfig as JaxConfig
from repro_torch.kernels.lbm_collide import ops
from repro_torch.kernels.lbm_collide.lbm_collide import lbm_halo_fill, lbm_stream_collide
from repro_torch.lbm.criteria import macroscopic
from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
from repro_torch.lbm.halo import compile_rank_halo_plan, lower_halo_fill
from repro_torch.particles import ParticlesConfig

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


def _torch(mode, nranks, **over):
    return AMRLBM(LidDrivenCavityConfig(nranks=nranks, stepping_mode=mode, device="cpu", **BASE, **over))


@pytest.fixture(scope="module")
def torch_restack():
    cache = {}

    def get(nranks):
        if nranks not in cache:
            sim = _torch("restack", nranks)
            cache[nranks] = (sim, _run(sim))
        return cache[nranks]

    return get


@pytest.fixture(scope="module")
def jax_restack():
    cache = {}

    def get(nranks):
        if nranks not in cache:
            sim = JaxAMRLBM(JaxConfig(nranks=nranks, stepping_mode="restack", kernel_backend="ref", **BASE))
            cache[nranks] = (sim, _run(sim))
        return cache[nranks]

    return get


@pytest.mark.parametrize(
    "mode, nranks, over",
    [
        ("sharded", 1, {}),
        ("sharded", 4, {}),
        ("sharded", 13, {}),
        ("fused_sharded", 1, {}),
        ("fused_sharded", 4, {}),
        ("fused_sharded", 13, {}),
        ("fused_sharded", 4, dict(overlap_split=True)),
        ("fused_sharded", 13, dict(overlap_split=True)),
        ("fused_sharded", 4, dict(overlap_split=True, kernel_backend="ref")),
        ("fused_sharded", 13, dict(kernel_backend="ref")),
    ],
    ids=["sharded-1", "sharded-4", "sharded-13", "fused_sharded-1", "fused_sharded-4",
         "fused_sharded-13", "split-4", "split-13", "split-ref-4", "unsplit-ref-13"],
)
def test_sharded_modes_equal_restack_bitwise(torch_restack, mode, nranks, over):
    ref, ref_forests = torch_restack(nranks)
    sim = _torch(mode, nranks, **over)
    forests = _run(sim)
    assert sim.amr_cycles >= 1 and len(sim.forest.levels_in_use()) > 1
    assert forests == ref_forests
    if mode == "fused_sharded" and nranks > 1:
        # at 13 ranks every block a rank steps borders another rank, so no
        # rank has interior blocks to step apart and the split is not taken
        progs = sim.engine._programs()
        assert bool(any(progs.interiors.values())) == (bool(over.get("overlap_split")) and nranks == 4)
    want = {b.bid: b for b in ref.forest.all_blocks()}
    for b in sim.forest.all_blocks():
        np.testing.assert_array_equal(
            sim.spec.interior(b.data["pdf"]), sim.spec.interior(want[b.bid].data["pdf"]), err_msg=hex(b.bid)
        )
    assert sim.total_mass() == ref.total_mass()


@pytest.mark.parametrize(
    "mode, nranks",
    [("sharded", 4), ("fused_sharded", 4), ("sharded", 13), ("fused_sharded", 13)],
)
def test_sharded_modes_match_jax_restack(jax_restack, mode, nranks):
    ref, ref_forests = jax_restack(nranks)
    sim = _torch(mode, nranks)
    forests = _run(sim)
    assert forests == ref_forests
    want = {b.bid: b for b in ref.forest.all_blocks()}
    sl = (slice(1, -1),) * 3
    for b in sim.forest.all_blocks():
        rho, u = macroscopic(b.data["pdf"], sim.spec.lattice)
        rho_r, u_r = macroscopic(want[b.bid].data["pdf"], sim.spec.lattice)
        np.testing.assert_allclose(rho[sl], rho_r[sl], **TOL)
        np.testing.assert_allclose(u[(Ellipsis, *sl)], u_r[(Ellipsis, *sl)], **TOL)
    m, m_ref = sim.total_mass(), ref.total_mass()
    assert abs(m - m_ref) / m_ref < 1e-6


def _refined(mode="fused_sharded", nranks=4, **over):
    """A ``BASE`` run past its first AMR event (two levels in use)."""
    sim = _torch(mode, nranks, **over)
    sim.advance(AMR_INTERVAL)
    sim.adapt()
    assert len(sim.forest.levels_in_use()) > 1
    return sim


def _spy(monkeypatch, calls):
    """Record the fill and stencil launches of the rank programs; any index
    gather or scatter of ghost values raises."""
    fill, stencil = ops.lbm_halo_fill, ops.lbm_stream_collide

    def spy_fill(dst, src, kind, *args):
        calls.append(("fill", kind))
        fill(dst, src, kind, *args)

    def spy_stencil(f, mask, *, slots=None, out=None, halo=None, sources=None, **kw):
        calls.append(("halo" if halo is not None else "stencil", slots is not None))
        return stencil(f, mask, slots=slots, out=out, halo=halo, sources=sources, **kw)

    def no_index_op(*args):
        raise AssertionError("the cuda backend moved ghost values by index")

    monkeypatch.setattr(ops, "lbm_halo_fill", spy_fill)
    monkeypatch.setattr(ops, "lbm_stream_collide", spy_stencil)
    monkeypatch.setattr(ops, "_concat_vals", no_index_op)
    monkeypatch.setattr(ops, "_run_plan_ops", no_index_op)


def test_cuda_absorb_fills_every_ghost_before_any_stencil(monkeypatch):
    """On the ``cuda`` backend the engine's rank programs (absorb, or the
    interior and boundary halves) fill every ghost value inside the
    stencil: no fill launch, no index gather or scatter; each program
    launches one stencil a level it steps, through the halo route at every
    level where its blocks read rows (as many as its ``halo_steps``), the
    route always over a slot list (its blocks in neighbour order) and the
    plain stencil over one only in the split; and the route reads inbound
    payloads."""
    calls = []
    _spy(monkeypatch, calls)
    for split in (False, True):
        sim = _refined(overlap_split=split)
        progs = sim.engine._programs()
        per_program = []

        def marked(fn):
            def call(*args):
                calls.clear()
                out = fn(*args)
                per_program.append((fn, list(calls)))
                return out

            return call

        for table in (progs.absorbs, progs.interiors, progs.boundaries):
            for per in table.values():
                for r, fn in per.items():
                    per[r] = marked(fn)
        sim.advance(1)
        assert per_program
        halo_calls = with_payload = 0
        for fn, prog in per_program:
            assert not [c for c in prog if c[0] == "fill"], prog
            assert sum(what == "halo" for what, _s in prog) == fn.halo_steps and fn.fill_segments == 0
            halo_calls += fn.halo_steps
            with_payload += bool(fn.halo_steps and fn.__name__ in ("absorb", "boundary")
                                 and any(h.message_rows for h in fn.halo.values()))
        assert halo_calls > 0 and with_payload > 0
        halo_slots = [s for _fn, prog in per_program for what, s in prog if what == "halo"]
        stencil_slots = [s for _fn, prog in per_program for what, s in prog if what == "stencil"]
        assert halo_slots and all(halo_slots)
        assert not any(stencil_slots) or split


def test_factory_less_absorb_fills_every_ghost_before_any_stencil(monkeypatch):
    """Built without a halo stepper factory (the JAX package's ``None``
    form), a rank's absorb (split or not) on ``cuda`` runs its local fills
    from their sources and one ``values`` fill a message segment, in place,
    before any stencil; the split's halves step through slot lists."""
    calls = []
    sim = _refined(nranks=4)
    per_rank = sim.engine.arenas.per_rank
    levels = sorted(sim.forest.levels_in_use())
    rank_slots = {r: {l: per_rank[r].slots(l) for l in per_rank[r].levels()} for r in range(4) if per_rank[r].levels()}
    rng = np.random.default_rng(5)
    _spy(monkeypatch, calls)
    kinds, slot_steps = set(), 0
    for p in range(levels[-1] + 1):
        active = {l for l in levels if l >= levels[-1] - p}
        plan = compile_rank_halo_plan(sim.forest, sim.fields, rank_slots, fields=("pdf",), levels=active)
        for r in rank_slots:
            rl = per_rank[r].levels()
            recvs = [m for m in plan.messages if m.dst_rank == r]
            if not recvs or not active & set(rl):
                continue
            kw = dict(
                steppers={l: ops.make_stream_collide(omega=1.5, collision="trt", u_wall=(0.08, 0, 0)) for l in rl},
                masks={l: torch.from_numpy(np.array(per_rank[r].buffer(l, "mask"))) for l in rl},
                active_levels=active & set(rl), backend="cuda", device="cpu",
            )
            idx = {l: i for i, l in enumerate(rl)}
            pdfs = tuple(torch.from_numpy((0.05 + 0.01 * rng.standard_normal(per_rank[r].buffer(l, "pdf").shape))
                                          .astype(np.float32)) for l in rl)
            msgs = tuple(torch.from_numpy(rng.standard_normal((m.num_cells, 19)).astype(np.float32)) for m in recvs)
            absorb = ops.make_rank_absorb(recvs, plan.local.get(r), idx, **kw)
            interior, boundary = ops.make_rank_absorb_split(recvs, plan.local.get(r), idx, **kw)
            for which in ("absorb", "interior", "boundary"):
                state = interior(pdfs) if which == "boundary" else None
                calls.clear()
                if which == "absorb":
                    absorb(pdfs, msgs)
                elif which == "interior":
                    interior(pdfs)
                else:
                    boundary(state, msgs)
                prog = "".join(what[0] for what, _s in calls)
                assert "h" not in prog and prog == "f" * prog.count("f") + "s" * prog.count("s"), prog
                kinds |= {k for what, k in calls if what == "fill"}
                slot_steps += sum(s for what, s in calls if what == "stencil")
            assert absorb.fill_segments == interior.fill_segments + boundary.fill_segments > 0
            assert absorb.halo_steps == interior.halo_steps == boundary.halo_steps == 0
    assert "values" in kinds and kinds & {"same", "coarse", "fine"} and slot_steps > 0


def test_split_equals_unsplit_absorb_bitwise_for_every_rank_and_pattern():
    """Build both forms of every rank's substep on a two-level forest and
    run them on the same random buffers: the interior + boundary halves
    give the unsplit absorb's bits, on both backends, with and without a
    halo stepper factory."""
    sim = _refined(nranks=4)
    eng = sim.engine
    forest = sim.forest
    levels = sorted(forest.levels_in_use())
    per_rank = eng.arenas.per_rank
    ranks = [r for r in range(4) if per_rank[r].levels()]
    rank_slots = {r: {l: per_rank[r].slots(l) for l in per_rank[r].levels()} for r in ranks}
    rng = np.random.default_rng(3)
    split_seen = 0
    for p in range(levels[-1] + 1):
        active = {l for l in levels if l >= levels[-1] - p}
        plan = compile_rank_halo_plan(forest, sim.fields, rank_slots, fields=("pdf",), levels=active)
        for r in ranks:
            rl = per_rank[r].levels()
            idx = {l: i for i, l in enumerate(rl)}
            recvs = [m for m in plan.messages if m.dst_rank == r]
            rank_active = active & set(rl)
            if not recvs or not rank_active:
                continue
            pdfs = tuple(
                torch.from_numpy((0.05 + 0.01 * rng.standard_normal(per_rank[r].buffer(l, "pdf").shape)).astype(np.float32))
                for l in rl
            )
            msgs = tuple(torch.from_numpy(rng.standard_normal((m.num_cells, 19)).astype(np.float32)) for m in recvs)
            for backend, halo in itertools.product(("cuda", "ref"), (False, True)):
                phys = dict(omega=1.5, collision="trt", u_wall=(0.08, 0, 0))
                masks = {l: np.array(per_rank[r].buffer(l, "mask")) for l in rl}
                kw = dict(
                    steppers={l: ops.make_stream_collide(backend=backend, **phys) for l in rl},
                    masks={l: torch.from_numpy(masks[l]) for l in rl},
                    active_levels=rank_active,
                    backend=backend,
                    device="cpu",
                )
                if halo:  # the engines' form: one map a level, local and message rows
                    kw["halo_stepper_factory"] = lambda l, fill, index, messages=(), backend=backend, masks=masks: (
                        ops.make_halo_stream_collide(fill, index, messages=messages, mask=masks[l], backend=backend,
                                                     device="cpu", **phys))
                absorb = ops.make_rank_absorb(recvs, plan.local.get(r), idx, **kw)
                interior, boundary = ops.make_rank_absorb_split(recvs, plan.local.get(r), idx, **kw)
                want = absorb(tuple(t.clone() for t in pdfs), msgs)
                got = boundary(interior(tuple(t.clone() for t in pdfs)), msgs)
                for a, b in zip(got, want):
                    torch.testing.assert_close(a, b, rtol=0, atol=0)
                split_seen += 1
    assert split_seen > 0


def test_emit_payloads_keep_the_message_layout_and_leave_inputs_alone():
    sim = _refined(nranks=4)
    progs = sim.engine._programs()
    res = {r: sim.arenas.per_rank[r].device() for r in progs.ranks}
    p = progs.pattern[0]
    emitted = 0
    for r in progs.ranks:
        emit = progs.emits[p].get(r)
        if emit is None:
            continue
        pdfs = tuple(res[r].fetch(l, "pdf") for l in progs.rank_levels[r])
        before = [t.clone() for t in pdfs]
        for m, arr in zip(progs.sends[p][r], emit(pdfs)):
            assert arr.shape == (m.num_cells, 19) and arr.is_contiguous()
            assert arr.numel() * arr.element_size() == m.nbytes
            emitted += 1
        for a, b in zip(pdfs, before):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert emitted > 0


def test_message_targets_count_as_written_cells():
    """``_assert_fills_disjoint`` refuses a message row aimed at a ghost cell
    that a local fill also writes."""
    sim = _refined(nranks=4)
    eng = sim.engine
    levels = sorted(sim.forest.levels_in_use())
    per_rank = eng.arenas.per_rank
    rank_slots = {r: {l: per_rank[r].slots(l) for l in per_rank[r].levels()} for r in range(4) if per_rank[r].levels()}
    plan = compile_rank_halo_plan(sim.forest, sim.fields, rank_slots, fields=("pdf",), levels=set(levels))
    for r, local in plan.local.items():
        recvs = [m for m in plan.messages if m.dst_rank == r]
        fills = lower_halo_fill(local)
        if not recvs or not fills:
            continue
        rl = per_rank[r].levels()
        idx = {l: i for i, l in enumerate(rl)}
        nblocks = [per_rank[r].num_blocks(l) for l in rl]
        cells = int(np.prod(per_rank[r].buffer(rl[0], "mask").shape[1:]))
        ops._assert_fills_disjoint(fills, idx, nblocks, cells, recvs)
        l, f = next(iter(fills.items()))
        m = recvs[0]
        _dl, db, dc, n = m.scatter[0]
        db, dc = db.copy(), dc.copy()
        db[0], dc[0] = f.dst_slot[0], f.dst_cell[0]
        doctored = dataclasses.replace(m, scatter=((l, db, dc, n),) + m.scatter[1:])
        with pytest.raises(AssertionError, match="filled twice"):
            ops._assert_fills_disjoint(fills, idx, nblocks, cells, [doctored])
        return
    pytest.fail("no rank had both local fills and inbound messages")


def test_fused_sharded_steady_state_moves_nothing_and_counts_like_sharded():
    sim = _refined()
    host = _refined(mode="sharded")
    sim.advance(1)  # rebuilds the rank programs + uploads after the event
    host.advance(1)
    res = sim.engine.residencies()
    before = [(x.h2d_transfers, x.d2h_transfers) for x in res]
    assert sum(b[0] for b in before) > 0
    dev0, host0 = sim.data_stats["fused"], host.data_stats["halo"]
    d0 = (dev0.p2p_bytes, dev0.p2p_messages)
    h0 = (host0.p2p_bytes, host0.p2p_messages)
    sim.advance(2)
    host.advance(2)
    assert [(x.h2d_transfers, x.d2h_transfers) for x in res] == before
    # the same messages and bytes per substep as the host-sharded exchange
    d1 = (dev0.p2p_bytes - d0[0], dev0.p2p_messages - d0[1])
    h1 = (host0.p2p_bytes - h0[0], host0.p2p_messages - h0[1])
    assert d1 == h1 and d1[0] > 0
    lmax = max(sim.forest.levels_in_use())
    assert sim.data_stats["fused"].exchange_rounds == AMR_INTERVAL * 1 + 3 * 2**lmax


def test_overlap_split_resolves_from_the_device():
    assert not _torch("fused_sharded", 4).engine.split
    assert _torch("fused_sharded", 4, overlap_split=True).engine.split


@pytest.mark.parametrize("mode", ["sharded", "fused_sharded"])
def test_default_device_without_a_card_raises(monkeypatch, mode):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AMRLBM(LidDrivenCavityConfig(nranks=4, stepping_mode=mode, particles=ParticlesConfig(), **BASE))


def test_slot_list_and_values_fill_plain_paths_and_their_checks():
    """On CPU tensors the slot-list stencil steps only the listed blocks
    into ``out`` (bitwise the whole-stack step there) and the ``values``
    fill scatters rows; malformed operands are refused."""
    rng = np.random.default_rng(4)
    f = torch.from_numpy((0.05 + 0.01 * rng.standard_normal((5, 19, 6, 6, 6))).astype(np.float32))
    mask = torch.zeros((5, 6, 6, 6), dtype=torch.int32)
    mask[:, 0] = 1
    kw = dict(omega=1.5, collision="trt", u_wall=(0.08, 0.0, 0.0))
    slots = torch.tensor([4, 1], dtype=torch.int32)
    out = torch.full_like(f, 9.0)
    got = lbm_stream_collide(f, mask, slots=slots, out=out, **kw)
    whole = lbm_stream_collide(f, mask, **kw)
    assert got is out
    torch.testing.assert_close(out[[4, 1]], whole[[4, 1]], rtol=0, atol=0)
    assert bool((out[[0, 2, 3]] == 9.0).all())
    with pytest.raises(ValueError, match="must not be f"):
        lbm_stream_collide(f, mask, out=f, **kw)
    with pytest.raises(ValueError, match="slots"):
        lbm_stream_collide(f, mask, slots=slots.long(), **kw)

    dst = f.clone()
    rows = torch.from_numpy(rng.standard_normal((3, 19)).astype(np.float32))
    ds = torch.tensor([0, 2, 2], dtype=torch.int32)
    dc = torch.tensor([0, 5, 7], dtype=torch.int32)
    lbm_halo_fill(dst, rows, "values", ds, dc)
    flat = dst.view(5, 19, -1)
    for i in range(3):
        torch.testing.assert_close(flat[ds[i], :, dc[i]], rows[i], rtol=0, atol=0)
    with pytest.raises(ValueError, match="no source indices"):
        lbm_halo_fill(dst, rows, "values", ds, dc, ds, dc)
    with pytest.raises(ValueError, match="values src"):
        lbm_halo_fill(dst, rows[:2], "values", ds, dc)
