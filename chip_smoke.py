"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, measure.

    python3 chip_smoke.py

Runs from the root of a checkout (it puts ``src/`` on the path), needs one
CUDA card, and imports nothing of jax or of the JAX package. Phases, one
finding per line:

1. card and build: ``nvidia-smi`` name and power limit; ``nvcc`` builds the
   stencil and ghost-fill kernels from
   ``src/repro_torch/kernels/lbm_collide/csrc``; ``-Xptxas -v`` lines and,
   for every instantiation (f32/f64 x D3Q19/D3Q27 x BGK/TRT stencils,
   copy/fine/values fills), registers, local (spill) bytes, shared memory
   and theoretical occupancy. The f32 D3Q19 TRT stencil must keep at least
   50 % occupancy, and no instantiation may spill to local memory.
2. main path, the "full cavity": ``AMRLBM(LidDrivenCavityConfig(...)).run``
   on the hand-written kernels, D3Q19 TRT f32, 32^3 cells a block (34^3
   with the ghost layer), 4^3 roots, up to level 2, 12 coarse steps with
   AMR every 4, first in ``fused`` mode (every level's ghost fill from its
   sources, then every level's stencil, each substep), then in ``arena``
   mode (the stencil kernel). Launch counts are zeroed just before each run
   and read just after. Prints blocks per level, peak device memory, coarse
   steps/s, MLUPS, mass drift, the fused run's steady-state transfers, and
   the ``torch.profiler`` breakdown of a steady fused step, which must hold
   no index gather, no ``cat`` and one fill launch per (level, segment) a
   substep. Then the superstep's rebuild after an AMR event, timed piece by
   piece (ghost plans, merged fills, disjointness checks, fill tables).
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it (real state and a real compiled fill of the full
   cavity): the stencil at B = 64; the level-2 fill from its sources plus
   the stencil; the padded-slab form once. Then small D3Q27 / BGK / f64 /
   odd-extent cases for the stencil and every fill segment kind (``same``,
   ``coarse``, ``fine``) in f32/f64 x D3Q19/D3Q27. Max error, kernel time,
   plain time and the bound.
4. cross-check at a smaller depth: ``restack``, ``arena`` and ``fused`` on
   the kernels and ``fused`` on the plain versions grow the same forest and
   agree on the interior fields.
5. the ``kernels`` JSON line, the card line, and the final ``ok`` line.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
TOL = {torch.float32: dict(rtol=3e-5, atol=3e-6), torch.float64: dict(rtol=1e-11, atol=1e-12)}
PHYSICS = dict(omega=1.5, u_lid=(0.08, 0.0, 0.0), refine_upper=0.03, refine_lower=0.004)
FULL_CAVITY = dict(
    cells_per_block=(32, 32, 32),
    ghost=1,
    root_grid=(4, 4, 4),
    max_level=2,
    nranks=4,
    balancer="diffusion-pushpull",
    collision="trt",
    **PHYSICS,
)
CROSS_CHECK = dict(cells_per_block=(32, 32, 32), root_grid=(2, 2, 2), max_level=1, nranks=4, **PHYSICS)
KERNEL1_REPLACES = "src/repro/kernels/lbm_collide/lbm_collide.py:212"
KERNEL2_REPLACES = "src/repro/kernels/lbm_collide/lbm_collide.py:248"
KERNEL_SOURCE = "src/repro_torch/kernels/lbm_collide/csrc/lbm_collide.cu"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def say(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flops_per_fluid_cell(Q: int, collision: str) -> int:
    """Floating-point operations the stencil does per fluid cell, counted
    from the kernel source: moments 7Q-1 (sum, three FMA chains), velocity
    and |u|^2 9, equilibrium 15 per direction, collision 12 (TRT) or 3 (BGK)
    per direction. Non-fluid cells only copy."""
    return 7 * Q - 1 + 9 + Q * (15 + (12 if collision == "trt" else 3))


def stencil_bound_ms(f: torch.Tensor, mask: torch.Tensor, collision: str, extra_bytes: int = 0):
    """Least time for the stencil on these inputs: the larger of its bytes
    (read f and mask once, write f once, plus ``extra_bytes``) over HBM
    bandwidth and its fp32 operations on this mask's fluid cells over the
    fp32 peak."""
    B, Q = f.shape[:2]
    nbytes = 2 * f.numel() * f.element_size() + mask.numel() * mask.element_size() + extra_bytes
    fluid = int((mask == 0).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = fluid * flops_per_fluid_cell(Q, collision) / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fill_traffic(tables, cells: int) -> dict:
    """What a from-sources fill must move, each item once: its ghost rows
    (Q values written each), the distinct source cells it reads (Q values
    each: a coarse cell that feeds several fine ghost rows, or a cell that
    two rows share, counts once) and its int32 index bytes. Source
    cells are split by whether they lie in the destination's own buffer
    (``same`` rows) or in another level's."""
    rows = sum(t.dst_slot.numel() for t in tables)
    index_bytes = sum(a.numel() * a.element_size() for t in tables
                      for a in (t.dst_slot, t.dst_cell, t.src_slot, t.src_cell))
    keys = {}
    for t in tables:
        slot = t.src_slot.cpu().numpy().astype(np.int64)
        cell = t.src_cell.cpu().numpy()
        if cell.ndim == 2:
            slot = np.repeat(slot, cell.shape[1])
        keys.setdefault(t.kind == "same", []).append(slot * cells + cell.ravel())
    # kinds read different source levels, so distinct (level, slot, cell)
    # triples are distinct keys within each group
    src = {own: int(np.unique(np.concatenate(k)).size) for own, k in keys.items()}
    return dict(rows=rows, index_bytes=index_bytes, src_own=src.get(True, 0), src_other=src.get(False, 0),
                rows_by_kind={t.kind: t.dst_slot.numel() for t in tables})


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from repro_torch.kernels.lbm_collide import build as kbuild
    from repro_torch.kernels.lbm_collide.lbm_collide import (
        kernel_attributes,
        lbm_halo_fill,
        lbm_stream_collide,
        lbm_stream_collide_halo,
    )
    from repro_torch.kernels.lbm_collide.ops import (
        _assert_fills_disjoint,
        _concat_vals,
        _lower_fill_gathers,
        _pad_fill_layout,
        _same_fill,
        fill_tables,
    )
    from repro_torch.kernels.lbm_collide.ref import (
        collision_coeffs,
        halo_fill_ref,
        stream_collide_coeffs,
        stream_collide_ref,
    )
    from repro_torch.lbm.criteria import macroscopic
    from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
    from repro_torch.lbm.forests import refined_forest
    from repro_torch.lbm.halo import compile_ghost_plan, lower_halo_fill
    from repro_torch.lbm.lattice import D3Q19, D3Q27, omega_for_level

    counters = (lbm_stream_collide, lbm_halo_fill, lbm_stream_collide_halo)
    card = card_line()
    say("card:", card)
    say(
        "torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0), "count", torch.cuda.device_count(),
    )

    # -- 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = kbuild.build()
    kbuild.load_library()
    say(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s (one nvcc, sm_90a)")
    if log:
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                say("  ptxas:", line.strip())
        check(bool(re.search(r"bytes spill stores", log)), "ptxas reported its spills")
    attrs = kernel_attributes()
    for r in attrs:
        say(f"  kernel {r['kernel']:7s} {r['variant']:6s} {r['dtype']} Q={r['Q']}: "
            f"{r['registers']} registers, {r['local_bytes']} local (spill) bytes, {r['shared_bytes']} shared bytes, "
            f"{r['ctas_per_sm']} CTAs of 256 per SM, occupancy {r['occupancy']:.1%}")
    # the f32 D3Q19 stencils are capped at 64 registers (4 CTAs of 256
    # threads, 50 % occupancy); no instantiation may spill
    for r in attrs:
        check(r["local_bytes"] == 0, f"no local memory: {r}")
    check(not re.search(r"[1-9]\d* bytes spill", log or ""), "ptxas reported no spill")
    main_stencil = next(r for r in attrs if r["kernel"] == "stencil" and r["variant"] == "trt"
                        and r["dtype"] == "f32" and r["Q"] == 19)
    check(main_stencil["occupancy"] >= 0.5, "the f32 D3Q19 TRT stencil keeps 50 % occupancy")
    main_fills = [r for r in attrs if r["kernel"] == "fill" and r["dtype"] == "f32" and r["Q"] == 19
                  and r["variant"] in ("copy", "fine")]

    # -- 2. main path: the full cavity, fused and arena --------------------------
    def drive_cavity(mode: str):
        """``AMRLBM(cfg).run(12, amr_interval=4)``, unrolled so each coarse
        step and AMR event is timed; launch counts zeroed just before and
        read just after."""
        cfg = LidDrivenCavityConfig(stepping_mode=mode, kernel_backend="cuda", **FULL_CAVITY)
        say(f"[{mode}] main path config:",
            json.dumps({k: v for k, v in vars(cfg).items() if k != "obstacle_fn"}))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters:
            fn.launches = 0
        t_main = time.perf_counter()
        sim = AMRLBM(cfg)
        check(sim.device.type == "cuda", "the main path runs on the card")
        mass0 = sim.total_mass()
        step_s, amr_s, transfers, levels_at = [], [], [], []
        for i in range(12):
            levels_at.append({l: sim.arena.num_blocks(l) for l in sim.arena.levels()})
            if mode == "fused":
                res = sim.arena.device()
                transfers.append((res.h2d_transfers, res.d2h_transfers))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.advance(1)  # fused: ends in a device synchronize; arena: copies back
            step_s.append(time.perf_counter() - t0)
            if (i + 1) % 4 == 0:
                t0 = time.perf_counter()
                sim.adapt()
                amr_s.append(time.perf_counter() - t0)
        if mode == "fused":
            res = sim.arena.device()
            transfers.append((res.h2d_transfers, res.d2h_transfers))
        mass1 = sim.total_mass()
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t_main
        launches = {fn.__name__: fn.launches for fn in counters}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # steady state: steps 10 and 11 (step 9 follows the second AMR event:
        # in fused mode it uploads and builds the superstep; step 12 is
        # followed by an AMR event)
        steady = range(9, 11)
        steady_s = sum(step_s[i] for i in steady)
        forest_steady = levels_at[10]
        check(sim.coarse_step == 12 and sim.amr_cycles >= 2, "12 coarse steps spanning two AMR events")
        check(len(forest_steady) == 3, f"three levels step after the second AMR event: {forest_steady}")
        cells = int(np.prod(cfg.cells_per_block))
        updates = sum(n * cells * 2**l for l, n in forest_steady.items())
        say(f"[{mode}] blocks per level during steps 9-12:", json.dumps(forest_steady))
        say(f"[{mode}] blocks per level after step 12:",
            json.dumps({l: sim.arena.num_blocks(l) for l in sim.arena.levels()}))
        say(f"[{mode}] peak device memory: {peak_gb:.3f} GB")
        say(f"[{mode}] coarse step wall times (s):", json.dumps([round(t, 4) for t in step_s]))
        say(f"[{mode}] AMR event wall times (s):", json.dumps([round(t, 3) for t in amr_s]))
        say(
            f"[{mode}] steady state (steps 10-11): {len(steady) / steady_s:.3f} coarse steps/s, "
            f"{updates * len(steady) / steady_s / 1e6:.1f} MLUPS "
            f"({updates} interior cell updates per coarse step)"
        )
        say(f"[{mode}] main path wall time {main_s:.2f} s")
        drift = abs(mass1 - mass0) / mass0
        say(f"[{mode}] mass: {mass0:.6f} -> {mass1:.6f}, relative drift {drift:.3e} (limit 1e-5)")
        check(drift <= 1e-5, "mass drift within 1e-5 relative")
        if mode == "fused":
            t_a, t_b = transfers[steady.start], transfers[steady.stop]
            say(f"[{mode}] steady-state h2d/d2h transfers over steps 10-11: "
                f"{t_b[0] - t_a[0]}/{t_b[1] - t_a[1]}")
            check(t_a == t_b, "zero host<->device transfers in steady state")
        say(f"[{mode}] kernel launches:", json.dumps(launches))
        sim.materialize_host()
        for b in sim.forest.all_blocks():
            check(bool(np.isfinite(sim.spec.interior(b.data["pdf"])).all()), "finite interior pdfs")
        return sim, launches

    # fused: every level's fill from its sources, then every level's stencil;
    # arena: the stencil alone, with a host round trip every substep
    sim, fused_launches = drive_cavity("fused")
    check(fused_launches["lbm_halo_fill"] > 0, "the fill kernel launched on the fused path")
    check(fused_launches["lbm_stream_collide"] > 0, "the stencil kernel launched on the fused path")
    _arena_sim, arena_launches = drive_cavity("arena")
    check(arena_launches["lbm_stream_collide"] > 0, "the stencil kernel launched on the arena path")
    del _arena_sim
    cfg = sim.cfg
    res = sim.arena.device()

    # where a steady fused coarse step spends device time, by kernel name
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sim.advance(1)  # the superstep is rebuilt after the last AMR event
    fill_segments = sim.engine._fused_program()[0].fill_segments
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.advance(2)  # ends in a device synchronize
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    busy_ms = sum(r[1] for r in rows)
    say(f"[fused] profile of 2 steady coarse steps: device busy {busy_ms:.3f} ms of "
        f"{wall_ms:.3f} ms wall, idle share {1 - busy_ms / wall_ms:.1%}")
    for name, ms, count in rows[:10]:
        say(f"  {ms:9.3f} ms {ms / busy_ms:6.1%} x{count:<5d} {name[:110]}")
    banned = [r[0] for r in rows if re.search(r"index|gather|scatter|cat", r[0], re.IGNORECASE)]
    check(not banned, f"no index gather, scatter or cat in the steady fused step: {banned}")
    fills_seen = sum(r[2] for r in rows if "halo_fill_kernel" in r[0])
    say(f"[fused] fill launches in 2 steady coarse steps: {fills_seen} "
        f"(one per (active level, segment) a substep: {2 * fill_segments})")
    check(fills_seen == 2 * fill_segments, "one fill launch per (active level, segment) a substep")

    # the superstep's rebuild after an AMR event (host work): whole, then
    # piece by piece on the same forest
    eng = sim.engine
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._fused_fn = None
    eng._fused_program()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    levels = sim.arena.levels()
    lmax = levels[-1]
    index = {l: i for i, l in enumerate(levels)}
    slots = {l: sim.arena.slots(l) for l in levels}
    nblocks = [sim.arena.num_blocks(l) for l in levels]
    cells = int(np.prod(sim.arena.buffer(lmax, "pdf").shape[2:]))
    t0 = time.perf_counter()
    plans = [compile_ghost_plan(sim.forest, sim.fields, slots, fields=("pdf",),
                                levels={l for l in levels if l >= lmax - p}) for p in range(lmax + 1)]
    plans_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pattern_fills = [lower_halo_fill(pl) for pl in plans]
    lower_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for fl in pattern_fills:
        _assert_fills_disjoint(fl, index, nblocks, cells)
    disjoint_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for fl in pattern_fills:
        for f in fl.values():
            fill_tables(f, index, "cuda")
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    distinct = []
    for fl in pattern_fills:
        for l, f in fl.items():
            if not any(l == m and _same_fill(f, g) for m, g in distinct):
                distinct.append((l, f))
    n_fills = sum(len(fl) for fl in pattern_fills)
    say(f"[fused] superstep rebuild: {build_s:.3f} s. Its pieces, timed alone: ghost plans of "
        f"{len(plans)} patterns {plans_s:.3f} s, merged fills {lower_s:.3f} s, disjointness checks "
        f"{disjoint_s:.3f} s, fill tables of all {n_fills} (pattern, level) fills {tables_s:.3f} s "
        f"(the build makes tables for the {len(distinct)} distinct ones)")

    # -- 3. kernels against their plain versions, main-path shapes ---------------
    lattice = sim.spec.lattice
    kw_l = {l: dict(omega=omega_for_level(cfg.omega, l), lattice=lattice,
                    u_wall=cfg.u_lid, collision=cfg.collision) for l in levels}
    bufs = [res.fetch(l, "pdf") for l in levels]
    masks = [res.fetch(l, "mask") for l in levels]
    # the first 64 blocks, finest level first (the moving fluid under the lid)
    f64b = torch.cat(bufs[::-1])[:64].contiguous()
    m64b = torch.cat(masks[::-1])[:64].contiguous()
    check(f64b.shape == (64, 19, 34, 34, 34), f"main-path stack shape {tuple(f64b.shape)}")
    kw = kw_l[lmax]
    got = lbm_stream_collide(f64b, m64b, **kw)
    want = stream_collide_ref(f64b, m64b, **kw)
    torch.cuda.synchronize()
    k1_err = max_err(got, want)
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    del got, want
    k1_ms = time_ms(lambda: lbm_stream_collide(f64b, m64b, **kw), iters=50)
    k1_plain_ms = time_ms(lambda: stream_collide_ref(f64b, m64b, **kw), iters=5, warmup=1)
    k1_bound_ms, k1_by = stencil_bound_ms(f64b, m64b, cfg.collision)
    say(f"lbm_stream_collide D3Q19 TRT f32 B=64 34^3 (real cavity state, finest level first): max |err| {k1_err:.3e}, "
        f"kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, bound {k1_bound_ms:.4f} ms ({k1_by}), "
        f"{k1_bound_ms / k1_ms:.1%} of bound")
    del f64b, m64b

    # the halo step: real compiled fills of the cavity (every level of the
    # pattern that activates all levels), from their sources
    fills = pattern_fills[lmax]  # the pattern that activates every level
    tables = {l: fill_tables(f, index, "cuda") for l, f in fills.items()}
    check({t.kind for ts in tables.values() for t in ts} == {"same", "coarse", "fine"},
          "the cavity's fills hold every segment kind")

    def run_fill(fill_fn, l, work):
        for t in tables[l]:
            fill_fn(work[index[l]], work[t.src], t.kind, t.dst_slot, t.dst_cell, t.src_slot, t.src_cell)

    for l in levels:  # every level's fill, kernel against plain, bitwise in practice
        got, want = list(bufs), list(bufs)
        got[index[l]], want[index[l]] = bufs[index[l]].clone(), bufs[index[l]].clone()
        run_fill(lbm_halo_fill, l, got)
        run_fill(halo_fill_ref, l, want)
        torch.cuda.synchronize()
        err = max_err(got[index[l]], want[index[l]])
        torch.testing.assert_close(got[index[l]], want[index[l]], **TOL[torch.float32])
        say(f"lbm_halo_fill level {l}: segments "
            f"{[(t.kind, t.dst_slot.numel()) for t in tables[l]]}: max |err| {err:.3e}")
    del got, want

    i2 = index[lmax]
    f_fine, m_fine = bufs[i2], masks[i2]
    B2 = f_fine.shape[0]
    rows2 = fills[lmax].num_cells
    work = list(bufs)
    work[i2] = f_fine.clone()  # the fill writes its destination's ghost ring in place

    def halo_step():
        run_fill(lbm_halo_fill, lmax, work)
        return lbm_stream_collide(work[i2], m_fine, **kw)

    coeffs = collision_coeffs(kw["omega"], lattice=lattice, u_wall=cfg.u_lid,
                              collision=cfg.collision, dtype=np.float32)
    plain_work = list(bufs)

    def plain_halo_step():
        plain_work[i2] = f_fine.clone()
        run_fill(halo_fill_ref, lmax, plain_work)
        return stream_collide_coeffs(plain_work[i2], m_fine, coeffs, lattice=lattice, collision=cfg.collision)

    got, want = halo_step(), plain_halo_step()
    torch.cuda.synchronize()
    k2_err = max_err(got, want)
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    del got
    fill_ms = time_ms(lambda: run_fill(lbm_halo_fill, lmax, work), iters=30)
    sten2_ms = time_ms(lambda: lbm_stream_collide(work[i2], m_fine, **kw), iters=30)
    k2_ms = time_ms(halo_step, iters=30)
    k2_plain_ms = time_ms(plain_halo_step, iters=3, warmup=1)
    # bounds, each byte once: the fill alone reads its distinct source cells
    # and writes its rows; the halo step (fill + stencil, one function of the
    # pre-step buffers) reads the level's buffer except the ghost rows the
    # fill overwrites, the mask, the distinct source cells of other levels
    # and the index tables, and writes the stepped buffer
    cells2 = int(np.prod(f_fine.shape[2:]))
    row_bytes = lattice.Q * f_fine.element_size()
    tr = fill_traffic(tables[lmax], cells2)
    check(tr["rows"] == rows2, "the fill tables cover the merged fill")
    fbytes = (tr["rows"] + tr["src_own"] + tr["src_other"]) * row_bytes + tr["index_bytes"]
    fill_bound_ms = fbytes / HBM_BYTES_PER_S * 1e3
    sten2_bound_ms, _ = stencil_bound_ms(f_fine, m_fine, cfg.collision)
    k2_extra = (tr["src_other"] - tr["rows"]) * row_bytes + tr["index_bytes"]
    k2_bound_ms, k2_by = stencil_bound_ms(f_fine, m_fine, cfg.collision, extra_bytes=k2_extra)
    say(f"lbm_halo_fill level {lmax} rows by kind {json.dumps(tr['rows_by_kind'])}; distinct source cells: "
        f"{tr['src_own']} in the level's own buffer, {tr['src_other']} in other levels' "
        f"({tr['src_other'] / max(tr['rows'] - tr['rows_by_kind'].get('same', 0), 1):.3f} per coarse/fine row)")
    say(f"lbm_halo_fill level {lmax} from sources ({rows2} ghost rows, {len(tables[lmax])} launches): "
        f"{fill_ms:.4f} ms, bound {fill_bound_ms:.4f} ms ({fbytes / 1e9:.4f} GB), "
        f"{fill_bound_ms / fill_ms:.1%} of bound")
    say(f"lbm_stream_collide level {lmax} B={B2}: {sten2_ms:.4f} ms, bound {sten2_bound_ms:.4f} ms, "
        f"{sten2_bound_ms / sten2_ms:.1%} of bound")
    say(f"halo step level {lmax} (fill from sources + stencil), D3Q19 TRT f32 B={B2}: max |err| {k2_err:.3e}, "
        f"kernels {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms, bound {k2_bound_ms:.4f} ms ({k2_by}; "
        f"{k2_extra / 1e9:+.4f} GB beside the stencil's), {k2_bound_ms / k2_ms:.1%} of bound; "
        f"shares of their own bounds: fill {fill_bound_ms / fill_ms:.1%}, stencil {sten2_bound_ms / sten2_ms:.1%}")

    # the slab form once (the Pallas halo kernel's interface): same fill
    vals = _concat_vals(bufs, _lower_fill_gathers(fills[lmax], index, f_fine.device))
    entry, cell, valid = _pad_fill_layout(fills[lmax].dst_slot, fills[lmax].dst_cell, B2, f_fine.shape[2:])
    hv = vals[torch.as_tensor(entry, dtype=torch.long, device="cuda")].contiguous()
    cell_t, valid_t = torch.as_tensor(cell, device="cuda"), torch.as_tensor(valid, device="cuda")
    f_slab = f_fine.clone()
    got = lbm_stream_collide_halo(f_slab, m_fine, hv, cell_t, valid_t, **kw)
    torch.cuda.synchronize()
    slab_err = max_err(got, want)
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    del got, want
    slab_ms = time_ms(lambda: lbm_stream_collide_halo(f_slab, m_fine, hv, cell_t, valid_t, **kw), iters=30)
    slab_bytes = hv.numel() * hv.element_size() + cell_t.numel() * 4 + valid_t.numel()
    slab_bound_ms, _ = stencil_bound_ms(f_fine, m_fine, cfg.collision, extra_bytes=slab_bytes)
    say(f"lbm_stream_collide_halo (slab form) level {lmax} B={B2} P={cell.shape[1]}: max |err| {slab_err:.3e}, "
        f"{slab_ms:.4f} ms, bound {slab_bound_ms:.4f} ms (bytes, with the slab), "
        f"{slab_bound_ms / slab_ms:.1%} of bound")
    del f_slab, hv, vals, work, plain_work

    # small cases: stencil and slab form at D3Q27 / BGK / f64 / odd extents
    rng = np.random.default_rng(0)
    for lat, coll, dtype, shape in (
        (D3Q27, "bgk", torch.float32, (18, 18, 18)),
        (D3Q27, "trt", torch.float32, (10, 12, 14)),
        (D3Q19, "bgk", torch.float64, (16, 16, 16)),
        (D3Q19, "trt", torch.float64, (9, 11, 7)),
        (D3Q19, "trt", torch.float32, (33, 17, 35)),
        (D3Q27, "trt", torch.float64, (5, 3, 300)),
    ):
        B = 4
        w = torch.as_tensor(lat.w, dtype=dtype)[None, :, None, None, None]
        f = (w * (1 + 0.05 * torch.as_tensor(rng.standard_normal((B, lat.Q, *shape)), dtype=dtype))).cuda()
        mask = torch.zeros((B, *shape), dtype=torch.int32)
        mask[:, 0], mask[:, -1], mask[:, :, 0] = 1, 2, 1
        mask = mask.cuda()
        kw = dict(omega=1.3, lattice=lat, u_wall=(0.05, 0.01, 0.0), collision=coll)
        got, want = lbm_stream_collide(f, mask, **kw), stream_collide_ref(f, mask, **kw)
        torch.cuda.synchronize()
        err1 = max_err(got, want)
        torch.testing.assert_close(got, want, **TOL[dtype])
        # the slab form on a random ghost-ring fill of each block
        X, Y, Z = shape
        ring = np.flatnonzero(np.pad(np.zeros((X - 2, Y - 2, Z - 2), bool), 1, constant_values=True))
        slots_ = np.repeat(np.arange(B), 5 + np.arange(B))
        cells_ = np.concatenate([rng.choice(ring, 5 + b, replace=False) for b in range(B)])
        e, c, v = _pad_fill_layout(slots_, cells_, B, shape)
        rows = torch.as_tensor(rng.standard_normal((len(cells_), lat.Q)) * 0.01 + 0.05, dtype=dtype)
        args = (rows[torch.as_tensor(e, dtype=torch.long)], torch.as_tensor(c), torch.as_tensor(v))
        want = lbm_stream_collide_halo(f.cpu(), mask.cpu(), *args, **kw)
        got = lbm_stream_collide_halo(f.clone(), mask, *(a.cuda() for a in args), **kw)
        torch.cuda.synchronize()
        err2 = max_err(got.cpu(), want)
        torch.testing.assert_close(got.cpu(), want, **TOL[dtype])
        say(f"small case {lat.name} {coll} {str(dtype)[6:]} B={B} {shape}: "
            f"max |err| stencil {err1:.3e}, slab form {err2:.3e}")

    # small cases: the fill from sources, every segment kind, f32/f64 x D3Q19/D3Q27
    forest_s, reg_s, arena_s = refined_forest((6, 4, 8))
    levels_s = arena_s.levels()
    index_s = {l: i for i, l in enumerate(levels_s)}
    fills_s = lower_halo_fill(compile_ghost_plan(
        forest_s, reg_s, {l: arena_s.slots(l) for l in levels_s}, fields=("pdf",)))
    tables_s = {l: fill_tables(f, index_s, "cuda") for l, f in fills_s.items()}
    kinds = {t.kind for ts in tables_s.values() for t in ts}
    check(kinds == {"same", "coarse", "fine"}, f"the small forest's fills hold every kind: {kinds}")
    for lat in (D3Q19, D3Q27):
        for dtype in (torch.float32, torch.float64):
            sbufs = [
                torch.as_tensor(0.05 + 0.01 * rng.standard_normal(
                    (arena_s.num_blocks(l), lat.Q, *arena_s.buffer(l, "pdf").shape[2:])), dtype=dtype).cuda()
                for l in levels_s
            ]
            worst = 0.0
            for l, ts in tables_s.items():
                for t in ts:
                    got, want = list(sbufs), list(sbufs)
                    got[index_s[l]], want[index_s[l]] = sbufs[index_s[l]].clone(), sbufs[index_s[l]].clone()
                    args = (t.kind, t.dst_slot, t.dst_cell, t.src_slot, t.src_cell)
                    lbm_halo_fill(got[index_s[l]], got[t.src], *args)
                    halo_fill_ref(want[index_s[l]], want[t.src], *args)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(got[index_s[l]], want[index_s[l]], **TOL[dtype])
                    worst = max(worst, max_err(got[index_s[l]], want[index_s[l]]))
            say(f"small case fill {lat.name} {str(dtype)[6:]} (same/coarse/fine segments of a "
                f"{len(levels_s)}-level forest): max |err| {worst:.3e}")

    # -- 4. cross-check at a smaller depth ----------------------------------------
    runs = {}
    for mode, backend in (("restack", "cuda"), ("arena", "cuda"), ("fused", "cuda"), ("fused", "ref")):
        t0 = time.perf_counter()
        s = AMRLBM(LidDrivenCavityConfig(stepping_mode=mode, kernel_backend=backend, **CROSS_CHECK))
        s.run(8, amr_interval=4)
        s.materialize_host()
        runs[mode, backend] = s
        say(f"cross-check {mode}/{backend}: {s.forest.num_blocks()} blocks, levels "
            f"{s.forest.levels_in_use()}, mass {s.total_mass():.6f}, {time.perf_counter() - t0:.2f} s")
    ref = runs["restack", "cuda"]
    check(ref.amr_cycles >= 1 and len(ref.forest.levels_in_use()) > 1, "cross-check spans an AMR event")
    forest_ref = {(b.bid, b.level, b.owner) for b in ref.forest.all_blocks()}
    ref_blocks = {b.bid: b for b in ref.forest.all_blocks()}
    worst = 0.0
    for key, s in runs.items():
        check({(b.bid, b.level, b.owner) for b in s.forest.all_blocks()} == forest_ref,
              f"{key} grew the same forest")
        for b in s.forest.all_blocks():
            rho, u = macroscopic(b.data["pdf"], lattice)
            rho_r, u_r = macroscopic(ref_blocks[b.bid].data["pdf"], lattice)
            a = torch.from_numpy(np.concatenate([s.spec.interior(rho)[None], s.spec.interior(u)]))
            r = torch.from_numpy(np.concatenate([s.spec.interior(rho_r)[None], s.spec.interior(u_r)]))
            torch.testing.assert_close(a, r, **TOL[torch.float32])
            worst = max(worst, max_err(a, r))
    say(f"cross-check: restack/arena/fused on the kernels and fused on the plain versions agree: "
        f"same forest, interior rho/u max |diff| {worst:.3e} (rtol 3e-5, atol 3e-6)")

    # -- 5. the kernels line and the result -------------------------------------
    kernels = [
        dict(name="lbm_stream_collide", route="cuda", source=KERNEL_SOURCE, replaces=KERNEL1_REPLACES,
             launches=fused_launches["lbm_stream_collide"], max_abs_err=k1_err, ms=k1_ms,
             plain_ms=k1_plain_ms, bound_ms=k1_bound_ms, bound_by=k1_by, library_ms=None,
             registers=main_stencil["registers"], spills=main_stencil["local_bytes"],
             occupancy=main_stencil["occupancy"], shape="B=64 34^3 D3Q19 TRT f32"),
        # the halo kernel's work on the card: the from-sources fill of every
        # segment (launches: lbm_halo_fill) followed by the stencil
        dict(name="lbm_stream_collide_halo", route="cuda", source=KERNEL_SOURCE, replaces=KERNEL2_REPLACES,
             launches=fused_launches["lbm_halo_fill"], max_abs_err=k2_err, ms=k2_ms,
             plain_ms=k2_plain_ms, bound_ms=k2_bound_ms, bound_by=k2_by, library_ms=None,
             registers=max(r["registers"] for r in main_fills),
             spills=max(r["local_bytes"] for r in main_fills),
             entry="lbm_halo_fill (from sources) then lbm_stream_collide",
             shape=f"level {lmax} B={B2}, {rows2} ghost rows, D3Q19 TRT f32",
             fill_ms=fill_ms, fill_bound_ms=fill_bound_ms, slab_form_ms=slab_ms),
    ]
    say("card:", card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
