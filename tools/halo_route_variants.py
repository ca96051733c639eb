"""Time the `fused` path's halo route under variants of the CUDA source, to
take apart what a change of the HALO instantiation costs.

    PYTHONPATH=src python tools/halo_route_variants.py [--parent OLD.cu] [--rounds 50]

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
        for fn, argtypes in _SIGNATURES.items():
            if fn == "lbm_stream_collide_halo_map" and name == "parent":
                argtypes = _PARENT_HALO
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = _ParentLibrary(lib) if name == "parent" else lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="an older source (halo entry point without slots and strides)")
    ap.add_argument("--rounds", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("halo_route_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
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
        sources["parent"], flags["parent"] = args.parent.read_text(), ()

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


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
