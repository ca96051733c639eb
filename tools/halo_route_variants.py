"""Time the halo route under variants of the CUDA source or of its operands,
to take apart what a change of the route costs.

    PYTHONPATH=src python tools/halo_route_variants.py [--parent OLD.cu] [--rounds 50]
    PYTHONPATH=src python tools/halo_route_variants.py --rank [--parent OLD.cu] [--rounds 30]

Needs a card and ``nvcc``. The full cavity of ``chip_smoke.py`` runs 12
coarse steps in ``fused`` mode (three AMR events), then its level-2 halo
step (the pattern that activates every level) and one whole coarse step
are timed under each variant, in turn, as medians of single calls (CUDA
events, a sleep kernel ahead of each start). Each variant is the source's
f32 D3Q19 part with its edits (``VARIANTS``); ``--parent`` adds an older
source compiled whole, whose halo entry point takes no slot list and no
segment strides (that of the source before payload segments). Every
variant's output is held bitwise against the source's.
Prints one line a variant and a JSON line.

``--rank`` times the rank route instead: the full cavity runs 12 coarse
steps in ``fused_sharded`` mode, and the rank with the most level-2
boundary blocks takes its level-2 interior half, boundary half and
unsplit level through the route, as ``chip_smoke.py``'s phase 6 builds
them (its local rows, and the rows of the payloads that the senders' emits
build from the real state). Each runs, in turn, under four operand
variants of one source: (a) block order (the halves' sorted lists, the
whole stack without a list), (b) the neighbour
order of :func:`~repro_torch.kernels.lbm_collide.ops.neighbour_order`
(a full-length list for the unsplit level), (c) direction-major payloads
(each payload copied once to a contiguous (Q, N) tensor, its map entries
naming the row, its direction stride N: the most that coalescing the
payload reads could win) and (b)+(c); with ``--parent``, the parent source
under (a) too; with ``--groups 4,16``, sources whose launcher runs that
many slot-list entries together (host code only) under (b), and under
the neighbour order grown for groups of that size. Every output is held
bitwise against (a)'s; each time is printed with its share of the
route's byte bound. It also prints how many
launch groups of each list are whole octets, before and after the
neighbour order, and a histogram of the payload rows each CTA's map tile
names.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

# name -> (old text, new text) pairs applied to the source. A stacks-only
# launch (fused) takes the instantiation without PAYLOADS, whose direction
# strides are the constant n; the first three variants read a segment's
# stride there instead, for a redirected value, for the thread's own
# values, or (the launcher taking the PAYLOADS instantiation) for both
_REDIRECT_STRIDE = ("static_cast<int64_t>(q) * (PAYLOADS ? s.q : n);", "static_cast<int64_t>(q) * s.q;")
_OWN_STRIDE = ("        if constexpr (PAYLOADS) fq = s.q;\n", "        fq = s.q;\n")
_BOTH_STRIDES = ("payloads = payloads || seg_qstride[i] != n;", "payloads = true;")
_STAGING = (
    """    if (threadIdx.x == 0 && threadIdx.y == 0) {
#pragma unroll
      for (int s = 0; s < kHaloSegs; ++s) {
        if (s == h.nseg) break;
        const HaloSeg<T> seg = h.seg[s];
        hseg[s] = HaloSrc<T>{seg.src + member * seg.mstride, static_cast<int>(seg.qstride)};
      }
    }
""",
    """    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
    for (int s = 0; s < kHaloSegs; ++s) {
      if (tid == s) {
        const HaloSeg<T> seg = h.seg[s];
        hseg[s] = HaloSrc<T>{seg.src + member * seg.mstride, static_cast<int>(seg.qstride)};
      }
    }
""",
)
_SEGS3 = ("constexpr int kHaloSegs = 32;", "constexpr int kHaloSegs = 3;")
VARIANTS = {
    "source": (),
    "redirect stride from segment": (_REDIRECT_STRIDE,),
    "own stride from segment": (_OWN_STRIDE,),
    "both strides from segments": (_BOTH_STRIDES,),
    "one thread a segment": (_STAGING,),
    "3 segments": (_SEGS3,),
}


def _slot_group_edits(group: int) -> tuple:
    """Edits that make the launcher run the CTAs of ``group`` consecutive
    slot-list entries together (``kHaloGroup`` elsewhere): host code only,
    the kernel reads the group size at run time."""
    return (
        ("  h.group = kHaloGroup;\n", f"  h.group = slots != nullptr ? {group} : kHaloGroup;\n"),
        ("  const int64_t chunk = kMaxGridZ * kHaloGroup;", "  const int64_t chunk = kMaxGridZ * h.group;"),
        ("static_cast<int64_t>(h.tiles) * kHaloGroup > 0x7fffffff", "static_cast<int64_t>(h.tiles) * h.group > 0x7fffffff"),
        ("    const dim3 grid(h.tiles * kHaloGroup, X, static_cast<unsigned>((nb + kHaloGroup - 1) / kHaloGroup));",
         "    const dim3 grid(h.tiles * h.group, X, static_cast<unsigned>((nb + h.group - 1) / h.group));"),
    )


# the halo entry point of a source before payload segments and slot lists
_PARENT_HALO = (
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
    ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
)


class _ParentLibrary:
    """An older library behind the current C interface: the halo entry
    point drops the slot list and the segment strides (always null and X Y
    Z on ``fused``); every other entry point is the library's own."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def lbm_stream_collide_halo_map(self, dt, Q, trt, f, mask, out, slots, S, coef, M, B, X, Y, Z, om_a, om_b,
                                    lid, cells, nseg, srcs, mstrides, _qstrides, stream):
        assert slots is None, "the older halo entry point takes no slot list"
        return self._lib.lbm_stream_collide_halo_map(dt, Q, trt, f, mask, out, coef, M, B, X, Y, Z, om_a, om_b,
                                                     lid, cells, nseg, srcs, mstrides, stream)


def _compile(sources: dict, workdir: Path, part_flags: dict) -> dict:
    """name -> loaded library, one ``nvcc`` a source, all at once; prints
    ptxas's registers and spills of the f32 D3Q19 TRT HALO stencil."""
    from repro_torch.kernels.lbm_collide.build import _SIGNATURES, NVCC_FLAGS, _nvcc

    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu, so = workdir / f"v{i}.cu", workdir / f"v{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen([_nvcc(), *NVCC_FLAGS, *part_flags[name], "-o", str(so), str(cu)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        # the ptxas lines of the f32 D3Q19 TRT solo HALO stencil fused takes
        blocks = re.split(r"(?=ptxas info\s*: Compiling entry function)", log)
        for b in blocks:
            if re.search(r"stream_collide_kernelIfLi19ELb1ELb0ELb0ELb1E(?:Lb0E)?E", b):
                used = re.search(r"Used (\d+) registers", b)
                spill = re.search(r"(\d+) bytes spill stores", b)
                print(f"  {name}: HALO f32 D3Q19 TRT {used.group(1) if used else '?'} registers, "
                      f"{spill.group(1) if spill else '?'} bytes spill stores", flush=True)
        lib = ctypes.CDLL(str(so))
        # a source before payload segments: its halo entry point takes no
        # slot list and no strides
        older = "seg_qstride" not in sources[name]
        for fn, argtypes in _SIGNATURES.items():
            if fn == "lbm_stream_collide_halo_map" and older:
                argtypes = _PARENT_HALO
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = _ParentLibrary(lib) if older else lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="an older source of the kernels")
    ap.add_argument("--rank", action="store_true", help="time the rank route's halves and unsplit level")
    ap.add_argument("--groups", default="", help="with --rank: launch-group sizes over slot lists to time too "
                                                 "(comma separated, e.g. 4,16)")
    ap.add_argument("--rounds", type=int, default=None, help="single calls a variant (50; 30 with --rank)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("halo_route_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if args.rank:
        return rank_variants(args.parent, args.rounds or 30, [int(g) for g in args.groups.split(",") if g])
    args.rounds = args.rounds or 50
    import chip_smoke as cs
    from repro_torch.kernels.lbm_collide import build as kbuild
    from repro_torch.kernels.lbm_collide.lbm_collide import lbm_stream_collide
    from repro_torch.kernels.lbm_collide.ops import fill_tables, halo_map
    from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
    from repro_torch.lbm.halo import compile_ghost_plan, lower_halo_fill
    from repro_torch.lbm.lattice import omega_for_level

    cs.set_numerics()
    print("card:", cs.card_line(), flush=True)
    text = kbuild.SOURCE.read_text()
    sources, flags = {}, {}
    for name, edits in VARIANTS.items():
        t = text
        for old, new in edits:
            if t.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its edit does not match the source once")
            t = t.replace(old, new)
        sources[name], flags[name] = t, ("-DLBM_PART_DTYPE=0", "-DLBM_PART_Q=19")
    if args.parent is not None:
        old_text = args.parent.read_text()
        sources["parent"] = old_text
        flags["parent"] = ("-DLBM_PART_DTYPE=0", "-DLBM_PART_Q=19") if "LBM_PART_DTYPE" in old_text else ()

    with tempfile.TemporaryDirectory() as tmp:
        libs = _compile(sources, Path(tmp), flags)
        real_loader = kbuild.load_library

        def use(name):
            kbuild.load_library = lambda d, q, lib=libs[name]: lib

        use("source")
        cfg = LidDrivenCavityConfig(stepping_mode="fused", kernel_backend="cuda", **cs.FULL_CAVITY)
        sim = AMRLBM(cfg)
        for i in range(12):
            sim.advance(1)
            if (i + 1) % 4 == 0:
                sim.adapt()
        sim.advance(1)  # the superstep of the last forest, built
        torch.cuda.synchronize()
        levels = sim.arena.levels()
        lmax = levels[-1]
        index = {l: i for i, l in enumerate(levels)}
        res = sim.arena.device()
        bufs = [res.fetch(l, "pdf") for l in levels]
        masks = [res.fetch(l, "mask") for l in levels]
        slots = {l: sim.arena.slots(l) for l in levels}
        plan = compile_ghost_plan(sim.forest, sim.fields, slots, fields=("pdf",), levels=set(levels))
        tables = fill_tables(lower_halo_fill(plan)[lmax], index, "cuda")
        i2 = index[lmax]
        f2, m2 = bufs[i2], masks[i2]
        hmap = halo_map(tables, m2, sim.spec.lattice.Q)
        kw = dict(omega=omega_for_level(cfg.omega, lmax), lattice=sim.spec.lattice, u_wall=cfg.u_lid,
                  collision=cfg.collision)
        srcs = tuple(bufs)
        outs = {name: torch.empty_like(f2) for name in libs}
        rows2 = sum(t.dst_slot.numel() for t in tables)
        print(f"level {lmax}: {f2.shape[0]} blocks {tuple(f2.shape[2:])}, {rows2} ghost rows in {len(tables)} "
              f"segments; blocks per level {json.dumps({l: sim.arena.num_blocks(l) for l in levels})}", flush=True)

        def route(name):
            use(name)
            return lbm_stream_collide(f2, m2, halo=hmap, sources=srcs, out=outs[name], **kw)

        for name in libs:
            route(name)
        torch.cuda.synchronize()
        diffs = {name: float((outs[name] - outs["source"]).abs().max()) for name in libs}
        for name, d in diffs.items():
            cs.check(d == 0.0, f"{name}: the level-{lmax} route equals the source's bitwise ({d})")
        level = cs.median_ms({name: (lambda n=name: route(n)) for name in libs}, n=args.rounds)

        # one whole coarse step of fused (its 7 halo launches, and the host's
        # work, since advance ends in a synchronize) under each variant; each
        # call steps the state on
        def coarse(name):
            use(name)
            sim.advance(1)

        step = cs.median_ms({name: (lambda n=name: coarse(n)) for name in libs}, n=max(args.rounds // 5, 5))
        kbuild.load_library = real_loader
    rows = {name: dict(level_ms=level[name][0], level_quartiles=level[name][1:], coarse_step_ms=step[name][0],
                       coarse_step_quartiles=step[name][1:], max_abs_diff=diffs[name]) for name in libs}
    for name, r in rows.items():
        print(f"{name:22s} level-{lmax} route {r['level_ms']:.4f} ms ({r['level_quartiles'][0]:.4f}-"
              f"{r['level_quartiles'][1]:.4f}), coarse step {r['coarse_step_ms']:.4f} ms "
              f"({r['coarse_step_quartiles'][0]:.4f}-{r['coarse_step_quartiles'][1]:.4f}), "
              f"max |diff| {r['max_abs_diff']:.1e}", flush=True)
    print(json.dumps({"halo_route_variants": rows, "card": cs.card_line()}))
    return 0


def rank_variants(parent: Path | None, rounds: int, groups: list[int]) -> int:
    """The ``--rank`` mode (see the module's docstring)."""
    import chip_smoke as cs
    from repro_torch.kernels.lbm_collide import build as kbuild

    cs.set_numerics()
    print("card:", cs.card_line(), flush=True)
    part = ("-DLBM_PART_DTYPE=0", "-DLBM_PART_Q=19")
    text = kbuild.SOURCE.read_text()
    sources, flags = {"source": text}, {"source": part}
    if parent is not None:
        sources["parent"], flags["parent"] = parent.read_text(), part
    for g in groups:
        edited = text
        for old, new in _slot_group_edits(g):
            if edited.count(old) != 1:
                raise RuntimeError(f"group {g}: an edit does not match the source once")
            edited = edited.replace(old, new)
        sources[f"group {g}"], flags[f"group {g}"] = edited, part
    with tempfile.TemporaryDirectory() as tmp:
        libs = _compile(sources, Path(tmp), flags)
        real_loader = kbuild.load_library
        kbuild.load_library = lambda d, q, lib=libs["source"]: lib
        try:
            rows = _rank_cases(cs, libs, rounds)
        finally:
            kbuild.load_library = real_loader
    print(json.dumps({"halo_route_rank_variants": rows, "card": cs.card_line()}))
    return 0


def _rank_cases(cs, libs: dict, rounds: int) -> dict:
    """Build the rank route's level-2 cases of the full cavity's
    ``fused_sharded`` run and time every variant of each."""
    from repro_torch.kernels.lbm_collide.lbm_collide import (
        HALO_SEG_SHIFT,
        HALO_STAGE_BIT,
        HaloMap,
        _kernel_args,
        _stream_ptr,
        lbm_stream_collide,
    )
    from repro_torch.kernels.lbm_collide.ops import (
        _rank_rows,
        boundary_slot_sets,
        cube_groups,
        face_neighbours,
        fill_tables,
        halo_map,
        message_tables,
        neighbour_order,
    )
    from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
    from repro_torch.lbm.lattice import omega_for_level

    cfg = LidDrivenCavityConfig(stepping_mode="fused_sharded", kernel_backend="cuda", **cs.FULL_CAVITY)
    sim = AMRLBM(cfg)
    for i in range(12):
        sim.advance(1)
        if (i + 1) % 4 == 0:
            sim.adapt()
    sim.advance(1)  # the programs of the last forest, built, and the state resident
    torch.cuda.synchronize()
    progs = sim.engine._programs()
    p_all = progs.pattern[0]  # substep 0 activates every level
    lmax = progs.levels[-1]
    res = {r: sim.arenas.per_rank[r].device() for r in progs.ranks}
    pdfs = {r: tuple(res[r].fetch(l, "pdf") for l in progs.rank_levels[r]) for r in progs.ranks}

    def boundary_of(r):
        masks_r = {l: res[r].fetch(l, "mask") for l in progs.rank_levels[r]}
        return sorted(boundary_slot_sets(progs.recvs[p_all][r], masks_r).get(lmax, ()))

    r_s = max(progs.ranks, key=lambda r: len(boundary_of(r)) if lmax in progs.rank_levels[r] else -1)
    rl = progs.rank_levels[r_s]
    i_s = rl.index(lmax)
    f_r, m_r = pdfs[r_s][i_s], res[r_s].fetch(lmax, "mask")
    B, Q, X, Y, Z = f_r.shape
    dev = f_r.device
    n = X * Y * Z
    recvs = progs.recvs[p_all][r_s]
    payloads = []
    for m in recvs:
        sends = progs.sends[p_all][m.src_rank]
        payloads.append(progs.emits[p_all][m.src_rank](pdfs[m.src_rank])[next(i for i, x in enumerate(sends) if x is m)])
    idx = {l: i for i, l in enumerate(rl)}
    masks = {l: res[r_s].fetch(l, "mask") for l in rl}
    fills, inbound = _rank_rows(recvs, progs.plans[p_all].local.get(r_s), idx, masks, set(rl))
    local_t = fill_tables(fills[lmax], idx, dev)
    msg_t = message_tables(inbound[lmax], len(rl), dev)
    hm = halo_map(local_t + msg_t, m_r, Q)
    pay_segs = list(range(len(local_t), len(local_t) + len(msg_t)))
    # (c): each payload direction-major, its map entries naming the row
    pay_dm = [p.t().contiguous() for p in payloads]
    cells = hm.cells
    seg = cells >> HALO_SEG_SHIFT
    is_pay = (cells >= 0) & torch.isin(seg, torch.as_tensor(pay_segs, device=cells.device))
    off_mask = (1 << HALO_STAGE_BIT) - 1
    cells_dm = torch.where(is_pay, (cells & ~off_mask) | ((cells & off_mask) // Q), cells)
    kw = dict(omega=omega_for_level(cfg.omega, lmax), lattice=sim.spec.lattice, u_wall=cfg.u_lid,
              collision=cfg.collision)
    _c, (trt, om_a, om_b), lid = _kernel_args(f_r.dtype, magic=3.0 / 16.0, **kw)
    pre = pdfs[r_s]
    nb = face_neighbours(fills[lmax], (X, Y, Z))
    boundary_np = np.asarray(boundary_of(r_s), np.int32)
    interior_np = np.setdiff1d(np.arange(B, dtype=np.int32), boundary_np)
    stream = _stream_ptr(f_r.device)

    def launch(lib, out, slots, payloads_on, direction_major):
        tables = local_t + (msg_t if payloads_on else ())
        srcs, qs = [], []
        for t in tables:
            if t.kind == "values":
                mi = t.src - len(rl)
                srcs.append(pay_dm[mi] if direction_major else payloads[mi])
                qs.append(payloads[mi].shape[0] if direction_major else 1)
            else:
                srcs.append(pre[t.src])
                qs.append(n)
        k = len(tables)
        err = lib.lbm_stream_collide_halo_map(
            0, Q, trt, f_r.data_ptr(), m_r.data_ptr(), out.data_ptr(), None if slots is None else slots.data_ptr(),
            0 if slots is None else slots.numel(), None, 1, B, X, Y, Z, om_a, om_b,
            lid.ctypes.data_as(ctypes.c_void_p), (cells_dm if direction_major else cells).data_ptr(), k,
            (ctypes.c_void_p * k)(*(s.data_ptr() for s in srcs)), (ctypes.c_longlong * k)(*([0] * k)),
            (ctypes.c_longlong * k)(*qs), stream)
        if err != 0:
            raise RuntimeError(f"lbm_stream_collide_halo_map returned {err}")
        return out

    rows = {"rank": r_s, "level": lmax, "blocks": B, "payloads": [tuple(p.shape) for p in payloads]}
    print(f"rank {r_s} level {lmax}: {B} blocks ({interior_np.size} interior, {boundary_np.size} boundary), "
          f"{len(local_t)} local segments, payloads {[tuple(p.shape) for p in payloads]}", flush=True)
    cases = (("interior half", interior_np, False, True), ("boundary half", boundary_np, True, True),
             ("unsplit level", np.arange(B, dtype=np.int32), True, False))
    for label, listed, pay, listed_launch in cases:
        sel = torch.as_tensor(listed, dtype=torch.long, device=dev)
        parent_slots = torch.as_tensor(listed, device=dev) if listed_launch else None
        order = neighbour_order(listed, nb)
        assert sorted(order.tolist()) == sorted(listed.tolist())
        nb_slots = torch.as_tensor(order, device=dev)
        variants = {
            "(a) block order": ("source", parent_slots, False),
            "(b) neighbour groups": ("source", nb_slots, False),
            "(c) direction-major payloads": ("source", parent_slots, True),
            "(b)+(c)": ("source", nb_slots, True),
        }
        if "parent" in libs:
            variants["parent source, (a)"] = ("parent", parent_slots, False)
        for name in libs:
            if name.startswith("group "):
                g = int(name.split()[1])
                # the order of groups of 8, and one grown for groups of g
                variants[f"(b), {name}"] = (name, nb_slots, False)
                variants[f"(b) for {name}"] = (name, torch.as_tensor(neighbour_order(listed, nb, group=g),
                                                                     device=dev), False)
        outs = {v: torch.empty_like(f_r) for v in variants}
        fns = {v: (lambda v=v, a=a: launch(libs[a[0]], outs[v], a[1], pay, a[2])) for v, a in variants.items()}
        for fn in fns.values():
            fn()
        # the route through the wrapper, as the rank paths launch it
        wrapper = lbm_stream_collide(f_r, m_r, halo=hm if pay else HaloMap(hm.cells, local_t, m_r),
                                     sources=(*pre, *payloads) if pay else pre, slots=parent_slots,
                                     out=torch.empty_like(f_r), **kw)
        torch.cuda.synchronize()
        base = outs["(a) block order"][sel]
        diffs = {v: float((o[sel] - base).abs().max()) for v, o in outs.items()}
        diffs["wrapper"] = float((wrapper[sel] - base).abs().max())
        for v, d in diffs.items():
            cs.check(d == 0.0, f"{label}: {v} equals the block order's route bitwise ({d})")
        med = cs.median_ms(fns, n=rounds)
        tr = cs.route_traffic(local_t, msg_t if pay else (), listed, i_s, n)
        extra = (tr["src_outside"] + tr["payload_rows"] - tr["rows"]) * Q * f_r.element_size() + tr["index_bytes"]
        bound_ms, by = cs.stencil_bound_ms(f_r[sel], m_r[sel], cfg.collision, extra_bytes=extra)
        counts = cs.payload_tile_counts(cells, listed, pay_segs) if pay else np.zeros(0, np.int64)
        hist = cs.tile_histogram(counts)
        before = cube_groups(listed, nb)
        after = cube_groups(order, nb)
        groups = -(-len(listed) // 8)
        rows[label] = dict(blocks=int(listed.size), ghost_rows=tr["rows"], payload_rows=tr["payload_rows"],
                           bound_ms=bound_ms, bound_by=by, whole_octet_groups_before=before,
                           whole_octet_groups_after=after, groups=groups, payload_rows_per_tile=hist,
                           variants={v: dict(ms=m, quartiles=(q1, q3), share=bound_ms / m, max_abs_diff=diffs[v])
                                     for v, (m, q1, q3) in med.items()})
        print(f"{label}: {listed.size} blocks, {tr['rows']} ghost rows ({tr['payload_rows']} payload rows); whole "
              f"octets in its {groups} launch groups {before} before the neighbour order, {after} after; payload "
              f"rows a CTA tile names {json.dumps(hist)}; bound {bound_ms:.4f} ms ({by})", flush=True)
        for v, (m, q1, q3) in med.items():
            print(f"  {v:30s} {m:.4f} ms ({q1:.4f}-{q3:.4f}), {bound_ms / m:.1%} of bound, "
                  f"{m / med['(a) block order'][0] - 1:+.1%} on (a), max |diff| {diffs[v]:.1e}", flush=True)
        del outs, wrapper
    halves = {v: rows["interior half"]["variants"][v]["ms"] + rows["boundary half"]["variants"][v]["ms"]
              for v in rows["boundary half"]["variants"]}
    rows["halves_together_ms"] = halves
    print("the two halves together: " + ", ".join(f"{v} {m:.4f} ms" for v, m in halves.items()), flush=True)
    return rows


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
