"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, measure.

    python3 chip_smoke.py

Runs from the root of a checkout (it puts ``src/`` on the path), needs one
CUDA card, and imports nothing of jax or of the JAX package. Phases, one
finding per line:

1. card and build: ``nvidia-smi`` name and power limit; ``nvcc`` builds the
   stream+collide kernels from ``src/repro_torch/kernels/lbm_collide/csrc``.
2. main path, the "full cavity": ``AMRLBM(LidDrivenCavityConfig(...)).run``
   on the hand-written kernels, D3Q19 TRT f32, 32^3 cells a block (34^3
   with the ghost layer), 4^3 roots, up to level 2, 12 coarse steps with
   AMR every 4, first in ``fused`` mode (every level has a ghost fill, so
   every step goes through the halo kernel), then in ``arena`` mode (the
   stencil kernel). Launch counts are zeroed just before each run and read
   just after. Prints blocks per level, peak device memory, coarse steps/s,
   MLUPS, mass drift, and the fused run's steady-state transfers.
3. each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it (real state and a real compiled fill of the full
   cavity), plus small D3Q27 / BGK / f64 / odd-extent cases; max error,
   kernel time, plain time and the bound.
4. cross-check at a smaller depth: ``restack``, ``arena`` and ``fused`` on
   the kernels and ``fused`` on the plain versions grow the same forest and
   agree on the interior fields.
5. the ``kernels`` JSON line, the card line, and the final ``ok`` line.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
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
    (read f and mask once, write f once) over HBM bandwidth and its fp32
    operations on this mask's fluid cells over the fp32 peak."""
    B, Q = f.shape[:2]
    nbytes = 2 * f.numel() * f.element_size() + mask.numel() * mask.element_size() + extra_bytes
    fluid = int((mask == 0).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = fluid * flops_per_fluid_cell(Q, collision) / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from repro_torch.kernels.lbm_collide import build as kbuild
    from repro_torch.kernels.lbm_collide.lbm_collide import (
        lbm_stream_collide,
        lbm_stream_collide_halo,
    )
    from repro_torch.kernels.lbm_collide.ops import (
        _concat_vals,
        _lower_fill_gathers,
        _pad_fill_layout,
    )
    from repro_torch.kernels.lbm_collide.ref import (
        collision_coeffs,
        stream_collide_halo_ref,
        stream_collide_ref,
    )
    from repro_torch.lbm.criteria import macroscopic
    from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
    from repro_torch.lbm.halo import compile_ghost_plan, lower_halo_fill
    from repro_torch.lbm.lattice import D3Q19, D3Q27, omega_for_level

    card = card_line()
    say("card:", card)
    say(
        "torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0), "count", torch.cuda.device_count(),
    )

    # -- 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path, log = kbuild.build()
    kbuild.load_library()
    say(f"build: {lib_path.name} in {time.perf_counter() - t0:.2f} s (one nvcc, sm_90a)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            say("  ptxas:", line.strip())

    # -- 2. main path: the full cavity, fused (kernel 2) and arena (kernel 1) --
    def drive_cavity(mode: str):
        """``AMRLBM(cfg).run(12, amr_interval=4)``, unrolled so each coarse
        step and AMR event is timed; launch counts zeroed just before and
        read just after."""
        cfg = LidDrivenCavityConfig(stepping_mode=mode, kernel_backend="cuda", **FULL_CAVITY)
        say(f"[{mode}] main path config:",
            json.dumps({k: v for k, v in vars(cfg).items() if k != "obstacle_fn"}))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lbm_stream_collide.launches = 0
        lbm_stream_collide_halo.launches = 0
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
        launches = {
            "lbm_stream_collide": lbm_stream_collide.launches,
            "lbm_stream_collide_halo": lbm_stream_collide_halo.launches,
        }
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

    # fused runs every level through the halo kernel (every level of a
    # multi-block forest has a ghost fill); kernel 1 carries arena/restack
    sim, fused_launches = drive_cavity("fused")
    check(fused_launches["lbm_stream_collide_halo"] > 0, "the halo kernel launched on the fused path")
    _arena_sim, arena_launches = drive_cavity("arena")
    check(arena_launches["lbm_stream_collide"] > 0, "the stencil kernel launched on the arena path")
    del _arena_sim
    launches = {
        "lbm_stream_collide": arena_launches["lbm_stream_collide"],
        "lbm_stream_collide_halo": fused_launches["lbm_stream_collide_halo"],
    }
    cfg = sim.cfg
    res = sim.arena.device()

    # where a steady fused coarse step spends device time, by kernel name
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sim.advance(1)  # the superstep is rebuilt after the last AMR event
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

    # -- 3. kernels against their plain versions, main-path shapes -------------
    lattice = sim.spec.lattice
    levels = sim.arena.levels()
    lmax = levels[-1]
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

    # kernel 2: the finest level's fill from a real compiled plan of the cavity
    slots = {l: sim.arena.slots(l) for l in levels}
    plan = compile_ghost_plan(sim.forest, sim.fields, slots, fields=("pdf",), levels=set(levels))
    index = {l: i for i, l in enumerate(levels)}
    fill = lower_halo_fill(plan)[lmax]
    f_fine, m_fine = bufs[index[lmax]], masks[index[lmax]]
    vals = _concat_vals(bufs, _lower_fill_gathers(fill, index, f_fine.device))
    entry, cell, valid = _pad_fill_layout(fill.dst_slot, fill.dst_cell, f_fine.shape[0], f_fine.shape[2:])
    entry_t = torch.as_tensor(entry, dtype=torch.long, device="cuda")
    cell_t = torch.as_tensor(cell, device="cuda")
    valid_t = torch.as_tensor(valid, device="cuda")
    hv = vals[entry_t].contiguous()
    B2, P = cell.shape
    kw = kw_l[lmax]
    coeffs = collision_coeffs(kw["omega"], lattice=lattice, u_wall=cfg.u_lid,
                              collision=cfg.collision, dtype=np.float32)
    b_idx, p_idx = valid_t.nonzero(as_tuple=True)
    flat_vals, flat_cell = hv[b_idx, p_idx], cell_t[b_idx, p_idx].long()

    def plain2():
        return stream_collide_halo_ref(f_fine, flat_vals, b_idx, flat_cell, coeffs,
                                       mask=m_fine, lattice=lattice, collision=cfg.collision)

    want = plain2()
    f_work = f_fine.clone()  # the kernel fills its input's ghost ring in place
    got = lbm_stream_collide_halo(f_work, m_fine, hv, cell_t, valid_t, **kw)
    torch.cuda.synchronize()
    k2_err = max_err(got, want)
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    del got, want
    k2_ms = time_ms(lambda: lbm_stream_collide_halo(f_work, m_fine, hv, cell_t, valid_t, **kw), iters=30)
    k2_plain_ms = time_ms(plain2, iters=5, warmup=1)
    slab_bytes = hv.numel() * hv.element_size() + cell_t.numel() * 4 + valid_t.numel()
    k2_bound_ms, k2_by = stencil_bound_ms(f_fine, m_fine, cfg.collision, extra_bytes=slab_bytes)
    say(f"lbm_stream_collide_halo D3Q19 TRT f32 level {lmax} B={B2} P={P} (real cavity fill, "
        f"{int(valid.sum())} ghost rows): max |err| {k2_err:.3e}, kernel {k2_ms:.4f} ms, "
        f"plain {k2_plain_ms:.4f} ms, bound {k2_bound_ms:.4f} ms ({k2_by}), {k2_bound_ms / k2_ms:.1%} of bound")
    del f_work, hv, vals, flat_vals

    # small cases: D3Q27, BGK, f64, odd extents
    rng = np.random.default_rng(0)
    for lat, coll, dtype, shape in (
        (D3Q27, "bgk", torch.float32, (18, 18, 18)),
        (D3Q27, "trt", torch.float32, (10, 12, 14)),
        (D3Q19, "bgk", torch.float64, (16, 16, 16)),
        (D3Q19, "trt", torch.float64, (9, 11, 7)),
        (D3Q19, "trt", torch.float32, (33, 17, 35)),
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
        # kernel 2 on a random ghost-ring fill of each block
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
            f"max |err| stencil {err1:.3e}, halo {err2:.3e}")

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
             launches=launches["lbm_stream_collide"], max_abs_err=k1_err, ms=k1_ms,
             plain_ms=k1_plain_ms, bound_ms=k1_bound_ms, bound_by=k1_by, library_ms=None),
        dict(name="lbm_stream_collide_halo", route="cuda", source=KERNEL_SOURCE, replaces=KERNEL2_REPLACES,
             launches=launches["lbm_stream_collide_halo"], max_abs_err=k2_err, ms=k2_ms,
             plain_ms=k2_plain_ms, bound_ms=k2_bound_ms, bound_by=k2_by, library_ms=None),
    ]
    say("card:", card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
