"""Where the port's dry run spends its time: DTensor's sharding propagation,
timed per operation signature, while reduced cells are traced on a fake mesh.

Each cell (``ArchConfig.reduced()``, its sequence cut to 32 and its batch to
8, as the CPU tests cut them, unless ``--full``) is traced by ``run_cell`` on a fake process
group of the mesh's size. Every signature DTensor plans (an operation with
its operands' shapes and placements; each is planned once a process) is
timed; those above ``--threshold`` seconds are printed with whether an
operand holds a ``_StridedShard`` and the model line that issued it. With
``--cap S`` a signature still planning after ``S`` seconds has every
remaining candidate costed as unreachable, so the trace goes on (its time
is then a lower bound, marked ``capped``). One JSON line a cell follows:
status (``FAIL:`` and the exception where the trace raised), seconds,
signatures planned, planning seconds, counted FLOPs, collective bytes by
kind and argument bytes by kind.

``--dtensor-only`` leaves every operation to DTensor: ``mesh_scope`` then
holds no fixed placements (``repro_torch.sharding.fixed_placements``), which
it holds on every mesh otherwise.
``--full`` traces the cells at full size; ``--attribute`` adds each counted
collective's bytes by kind and by the model line that issued it (the
forward line of a backward collective, from autograd's anomaly mode).
``--why`` writes into a failing cell's line the operation that raised, its
operands' shapes and placements and the model line that issued it (the
innermost DTensor or fixed-placement operation that raised; a backward
one's forward line, from anomaly mode).

Usage:
  PYTHONPATH=src python tools/dryrun_plan_times.py --mesh 2,2,2 --arch qwen2-0.5b [--shape train_4k] \\
      [--cap 20] [--dtensor-only]
  PYTHONPATH=src python tools/dryrun_plan_times.py --mesh 2,2 --all --threshold 1e9 --json cells.json [--why]
  PYTHONPATH=src python tools/dryrun_plan_times.py --mesh 16,16 --full --arch qwen2-0.5b --shape train_4k \\
      --threshold 1e9 --attribute
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from dataclasses import replace

import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.placement_types import _StridedShard
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.sharding.fixed_placements as fixed_placements
from repro_torch.configs import all_arch_ids, cells_for, get_config
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import fake_process_group


class PlanTimer:
    """Times DTensor's propagation of each new signature, installed on the
    process's ``ShardingPropagator`` (its torch 2.13 entry points; where a
    torch lacks them, ``installed`` is False and only cells are timed)."""

    def __init__(self, threshold: float, cap: float | None):
        self.threshold, self.cap = threshold, cap
        self.records: list[tuple[float, bool]] = []
        self.started: float | None = None
        self.capped = False
        prop = DTensor._op_dispatcher.sharding_propagator
        try:
            import torch.distributed.tensor._ops.utils as strategy_utils
            from torch.distributed.tensor._sharding_prop import LocalLRUCache
        except ImportError:
            strategy_utils = None
        self.installed = (strategy_utils is not None and hasattr(prop, "propagate_op_sharding_non_cached")
                          and hasattr(strategy_utils, "redistribute_cost"))
        if not self.installed:
            return
        self._plan = prop.propagate_op_sharding_non_cached
        prop.propagate_op_sharding_non_cached = self._timed
        prop.propagate_op_sharding = LocalLRUCache(self._timed)
        self._cost = strategy_utils.redistribute_cost
        strategy_utils.redistribute_cost = self._capped_cost

    def _capped_cost(self, cur, dst):
        if self.cap is not None and self.started is not None and time.perf_counter() - self.started > self.cap:
            self.capped = True
            return 0.0 if cur.placements == dst.placements else float("inf")
        return self._cost(cur, dst)

    def _timed(self, schema):
        outer = self.started is None
        if outer:
            self.started, self.capped = time.perf_counter(), False
        t0 = time.perf_counter()
        try:
            return self._plan(schema)
        finally:
            if outer:
                dt = time.perf_counter() - t0
                self.started = None
                self.records.append((dt, self.capped))
                if dt > self.threshold:
                    specs = [a for a in schema.args_schema if hasattr(a, "placements")]
                    strided = any(isinstance(p, _StridedShard) for a in specs for p in a.placements)
                    shapes = ", ".join(f"{tuple(a.tensor_meta.shape)}{[str(p) for p in a.placements]}"
                                       for a in specs if a.tensor_meta is not None)
                    print(f"  {dt:8.3f} s{' capped' if self.capped else ''} strided={strided} "
                          f"{schema.op}({shapes})\n      at {_model_line()}", flush=True)


def _model_line() -> str:
    for frame in reversed(traceback.extract_stack()[:-3]):
        if ("repro_torch/models" in frame.filename or "repro_torch/train" in frame.filename) and frame.name != "wsc":
            return f"{frame.filename.split('src/')[-1]}:{frame.lineno} {frame.line.strip()[:72]}"
    return "?"


def _where() -> tuple[str, str]:
    """("forward" or "backward", the model line that issued the running
    operation); a backward line needs autograd's anomaly mode."""
    node = torch._C._current_autograd_node()
    if node is None:
        return "forward", _model_line()
    tb = node.metadata.get("traceback_")
    lines = "".join(tb if isinstance(tb, list) else [tb or ""]).splitlines()
    mine = [(line.strip(), lines[i + 1].strip() if i + 1 < len(lines) else "") for i, line in enumerate(lines)
            if ("repro_torch/models" in line or "repro_torch/train" in line) and "in wsc" not in line]
    return "backward", (f"{mine[-1][0].split('src/')[-1]}: {mine[-1][1][:60]}" if mine else node.name())


def _operands(args) -> list[str]:
    from torch.utils._pytree import tree_leaves

    return [f"{tuple(t.shape)}{[str(p) for p in t.placements]}" if isinstance(t, DTensor) else f"{tuple(t.shape)}plain"
            for t in tree_leaves(args) if isinstance(t, torch.Tensor)]


class FailureNotes(TorchDispatchMode):
    """Entered before a cell's trace (so below ``mesh_scope``'s fixed
    placements, above DTensor): on the first (innermost) operation that
    raises, in DTensor or in the rule, records the operation, its operands
    and the model line."""

    def __init__(self):
        from repro_torch.sharding.fixed_placements import FixedPlacements

        super().__init__()
        self.last: dict | None = None
        rule, notes = FixedPlacements.__torch_dispatch__, self

        def by_rule(mode, func, types, args=(), kwargs=None):
            with notes._noting("rule", func, args, kwargs):
                return rule(mode, func, types, args, kwargs)

        FixedPlacements.__torch_dispatch__ = by_rule
        torch.autograd.set_detect_anomaly(True, check_nan=False)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        with self._noting("dtensor", func, args, kwargs):
            return func(*args, **(kwargs or {}))

    @contextlib.contextmanager
    def _noting(self, who: str, func, args, kwargs):
        try:
            yield
        except Exception as e:
            if not getattr(e, "_noted", False):
                e._noted = True
                self.last = {"op": str(func), "by": who, "operands": _operands((args, kwargs or {})),
                             "line": " ".join(_where()), "error": str(e).splitlines()[0][:200]}
            raise


class Attribution:
    """Counted collective bytes by (kind, pass, model line), hooked on
    ``step_analysis``'s collective counter."""

    def __init__(self):
        import collections

        from repro_torch.launch import step_analysis

        self.bytes = collections.defaultdict(float)
        self.count = collections.Counter()
        counter, attribution = step_analysis._CollectiveBytes, self
        inner = counter.__torch_dispatch__

        def hooked(mode, func, types, args=(), kwargs=None):
            before = dict(mode.stats.collective_bytes)
            out = inner(mode, func, types, args, kwargs)
            for kind, n in mode.stats.collective_bytes.items():
                if n != before.get(kind, 0.0):
                    key = (kind, *_where())
                    attribution.bytes[key] += n - before.get(kind, 0.0)
                    attribution.count[key] += 1
            return out

        counter.__torch_dispatch__ = hooked
        torch.autograd.set_detect_anomaly(True, check_nan=False)

    def report(self) -> list[dict]:
        rows = [{"kind": k[0], "pass": k[1], "line": k[2], "gb": round(v / 1e9, 3), "calls": self.count[k]}
                for k, v in sorted(self.bytes.items(), key=lambda kv: -kv[1])]
        for row in rows:
            print(json.dumps(row), flush=True)
        return rows


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="2,2,2", help="2 axes (data, model) or 3 (pod, data, model)")
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--all", action="store_true", help="every arch's cells")
    ap.add_argument("--threshold", type=float, default=1.0, help="print signatures above this many seconds")
    ap.add_argument("--cap", type=float, default=None, help="stop costing a signature's candidates after S s")
    ap.add_argument("--json", default=None, help="write every cell's line into this file")
    ap.add_argument("--dtensor-only", action="store_true",
                    help="leave every operation to DTensor's planner (no fixed placements)")
    ap.add_argument("--full", action="store_true", help="the cells at full size (no cut)")
    ap.add_argument("--attribute", action="store_true", help="collective bytes by kind and model line")
    ap.add_argument("--why", action="store_true", help="a failing cell's operation, operands and model line")
    args = ap.parse_args(argv)
    attribution = Attribution() if args.attribute else None
    notes = FailureNotes() if args.why else None
    if args.dtensor_only:
        fixed_placements.FixedPlacements = lambda mesh: contextlib.nullcontext()

    torch.set_num_threads(1)
    shape = tuple(int(n) for n in args.mesh.split(","))
    axes = ("pod", "data", "model")[-len(shape):] if len(shape) == 3 else ("data", "model")
    timer = PlanTimer(args.threshold, args.cap)
    print(f"torch {torch.__version__}, 1 thread, fake mesh {dict(zip(axes, shape))}, planner timed: "
          f"{timer.installed}, fixed placements: {not args.dtensor_only}", flush=True)
    cells = {}
    with fake_process_group(int(torch.tensor(shape).prod())):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        for arch in args.arch or (all_arch_ids() if args.all else ["qwen2-0.5b"]):
            cfg = get_config(arch) if args.full else get_config(arch).reduced()
            for cell in cells_for(cfg):
                if args.shape and cell.shape_id not in args.shape:
                    continue
                if not args.full:
                    cell = replace(cell, seq_len=min(cell.seq_len, 32), global_batch=min(cell.global_batch, 8))
                timer.records.clear()
                t0 = time.perf_counter()
                try:
                    with notes if notes is not None else contextlib.nullcontext():
                        res = run_cell(cfg, cell, mesh, verbose=False)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    traceback.print_exc()
                    line = {"arch": arch, "shape": cell.shape_id, "s": round(time.perf_counter() - t0, 2),
                            "status": f"FAIL:{type(e).__name__}: {str(e).splitlines()[0][:160]}"}
                    if notes is not None:
                        line["raised"], notes.last = notes.last, None
                    cells[f"{arch}/{cell.shape_id}"] = line
                    print(json.dumps(line), flush=True)
                    continue
                line = {
                    "status": "OK", "arch": arch, "shape": cell.shape_id, "s": round(time.perf_counter() - t0, 2),
                    "signatures": len(timer.records), "planning_s": round(sum(r[0] for r in timer.records), 2),
                    "above_threshold": sum(r[0] > args.threshold for r in timer.records),
                    "capped": sum(r[1] for r in timer.records), "flops": res["flops"]["counted_cluster"],
                    "collective_bytes": res["collectives"]["bytes_by_kind"],
                    "collective_count": res["collectives"]["count_by_kind"],
                    "argument_bytes": res["memory"]["argument_bytes_by_kind"], "microbatches": res["microbatches"],
                }
                cells[f"{arch}/{cell.shape_id}"] = line
                print(json.dumps(line), flush=True)
                if attribution is not None:
                    line["attribution"] = attribution.report()
                    attribution.bytes.clear()
                    attribution.count.clear()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(cells, f, indent=1)
    return cells


if __name__ == "__main__":
    main()
