"""Dry run: place and trace every (architecture x shape x mesh) cell.

The twin of the JAX package's ``launch/dryrun.py``. The reference lowers
and compiles each cell for 512 host devices; the port cannot compile for a
mesh it does not have. Per cell it instead:

  * builds the model on the ``meta`` device with the reference's
    ``DistContext`` for the cell;
  * places parameters, optimizer state, batch and cache by
    ``repro_torch.sharding.specs`` on the mesh (DTensors over meta local
    shards: no memory), and reports each rank's argument bytes by kind;
  * reports ``model_flops`` and ``hbm_bytes_estimate`` (``perf_model``);
  * runs the cell's step once (a train step with the reference's
    microbatches and remat, prefill to last-position logits, or one
    ``decode``) inside ``mesh_scope`` under ``analyze_step``: FLOPs,
    ``useful_ratio``, this rank's collective bytes by kind and
    ``roofline_terms`` (left out with ``--no-trace``).

The CLI puts each mesh on torch's ``fake`` process group (256 or 512 ranks
as rank 0; its collectives move nothing), so it runs on one host. A cell
whose trace raises is reported ``FAIL:<exception>`` and, with ``--out``,
written as ``.err``; nothing is written without ``--out``. Both meshes are
traced, the multi-pod one as the single one: on its three axes
``mesh_scope`` places products, views and pointwise operations
(``repro_torch.sharding.fixed_placements``). With ``--jobs N`` each cell
runs in a process of its own, N at a time.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi --out /tmp/dryrun [--jobs 4]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from ..configs import SHAPES, all_arch_ids, cells_for, get_config
from ..configs.base import ArchConfig
from ..configs.shapes import ShapeConfig
from ..models.zoo import DistContext, build_model, logits_from_hidden
from ..sharding.specs import (
    batch_pspecs,
    cache_pspecs,
    opt_state_pspecs,
    param_pspecs,
    place,
    place_model,
    place_tree,
)
from ..train.optimizer import AdamWConfig, adamw_init
from ..train.train_step import make_train_step
from .inputs import cache_specs, input_specs
from .mesh import fake_process_group, make_production_mesh, mesh_axes, mesh_axis_sizes, mesh_devices, mesh_scope
from .perf_model import hbm_bytes_estimate, model_flops
from .step_analysis import StepStats, analyze_step, roofline_terms

__all__ = ["run_cell", "cell_step", "main"]


def _microbatches(cfg: ArchConfig, shape: ShapeConfig, n_batch_shards: int) -> int:
    if shape.kind != "train":
        return 1
    per_shard = shape.global_batch // max(1, n_batch_shards)
    want = 8 if cfg.d_model >= 4096 else 2
    mb = min(want, per_shard) or 1
    while shape.global_batch % (mb * n_batch_shards) and mb > 1:
        mb -= 1
    return max(1, mb)


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of a (nested dict of) DTensor(s)."""
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    local = tree.to_local()
    return local.numel() * local.element_size()


def run_cell(
    arch: str | ArchConfig,
    shape: str | ShapeConfig,
    mesh,
    *,
    layout: str = "tp-fsdp",
    microbatches: int | None = None,
    trace: bool = True,
    verbose: bool = True,
) -> dict:
    """One cell on ``mesh`` (a ``DeviceMesh`` with the production mesh's
    axis names; any sizes, 2-D or with "pod" first): ``arch`` and ``shape``
    by id or as configs. Without ``trace`` only the placement is made:
    argument bytes and the analytic model. With it the step runs once on
    the mesh: DTensor plans each new operation signature once, and on the
    3-D mesh ``mesh_scope`` places products, views and pointwise ops by one
    rule, where DTensor's own planning took more than 20 s a product
    (torch 2.13, one CPU core; ``PERF.md`` section 6)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    axes, sizes = mesh_axes(mesh), mesh_axis_sizes(mesh)
    n_chips = mesh_devices(mesh)
    multi_pod = "pod" in axes
    model_size = sizes.get("model", 1) if layout != "fsdp" else 1
    n_batch_shards = n_chips // model_size
    mesh_name = ("multi" if multi_pod else "single") + ("" if layout == "tp-fsdp" else f"-{layout}")

    batch_axes = ("pod", "data") if multi_pod else ("data",)
    if layout == "fsdp":
        batch_axes = batch_axes + ("model",)
    dist = DistContext(
        n_token_groups=n_batch_shards,
        remat=True,
        batch_axes=batch_axes,
        model_axis="model" if layout != "fsdp" else None,
        model_size=model_size,
        # decode caches with kv-heads not divisible by the model axis are
        # sequence-sharded; pin attention to contract T locally
        decode_seq_shard=(shape.kind == "decode" and cfg.n_kv % model_size != 0),
    )
    model = build_model(cfg, dist, device="meta", dtype=torch.bfloat16)
    batch = input_specs(cfg, shape)
    args: dict = {}
    if shape.kind == "train":
        opt = adamw_init(model)
        args["opt_state"] = place_tree(opt, opt_state_pspecs(cfg, opt, axes, sizes, layout=layout), mesh)
        b_spec = batch_pspecs(cfg, shape, axes, layout=layout)
    else:
        b_spec = batch_pspecs(cfg, shape, axes)
    if shape.kind == "decode":
        cache = cache_specs(model, shape)
        args["cache"] = place_tree(cache, cache_pspecs(cfg, shape, cache, axes, sizes), mesh)
    args["batch"] = {k: place(v, b_spec[k], mesh) for k, v in batch.items()}
    place_model(model, param_pspecs(cfg, model, axes, sizes, layout=layout), mesh)
    args["params"] = dict(model.named_parameters())
    by_kind = {k: _local_bytes(v) for k, v in args.items()}

    flops_model = model_flops(cfg, shape)
    hbm = hbm_bytes_estimate(cfg, shape)
    result = {
        "arch": cfg.arch_id,
        "shape": shape.shape_id,
        "mesh": mesh_name,
        "mesh_shape": dict(sizes),
        "n_chips": n_chips,
        "memory": {"argument_bytes": sum(by_kind.values()), "argument_bytes_by_kind": by_kind},
        "flops": {"model_cluster": flops_model},
        "hbm_bytes_estimate": hbm,
    }
    if trace:
        mb = (microbatches or _microbatches(cfg, shape, n_batch_shards)) if shape.kind == "train" else 1
        t0 = time.perf_counter()
        stats = _trace(model, shape, mesh, args, mb)
        result["microbatches"], result["trace_s"] = mb, round(time.perf_counter() - t0, 1)
        # MODEL_FLOPS / counted FLOPs: <1 means remat/padding waste
        result["flops"].update(counted_cluster=stats.flops, useful_ratio=round(flops_model / max(stats.flops, 1.0), 4))
        result["collectives"] = {
            "bytes_by_kind": dict(stats.collective_bytes),
            "count_by_kind": dict(stats.collective_count),
            "bytes_total": stats.collective_bytes_total,
        }
        result["roofline"] = roofline_terms(
            flops_per_device=max(stats.flops, flops_model) / n_chips,
            hbm_bytes_per_device=hbm / n_chips,
            collective_bytes_per_device=stats.collective_bytes_total,
            n_pods=sizes.get("pod", 1),
        )
    if verbose:
        print(f"--- {cfg.arch_id} x {shape.shape_id} x {mesh_name} ({n_chips} ranks) ---")
        print(json.dumps({k: result[k] for k in ("memory", "flops", "collectives", "roofline") if k in result},
                         indent=1)[:1600])
    return result


def cell_step(model, shape: ShapeConfig, args: dict, microbatches: int) -> tuple:
    """The cell's step as a function and its arguments: the train step
    (``microbatches``), the prefill to the last position's logits, or one
    decode step."""
    if shape.kind == "train":
        return make_train_step(model, AdamWConfig(), microbatches=microbatches), (args["opt_state"], args["batch"])
    if shape.kind == "prefill":

        def prefill(b):
            h, _aux = model.hidden(b)
            # last-position logits (the served token distribution)
            return logits_from_hidden(model, h[:, -1:])

        return prefill, (args["batch"],)
    b = dict(args["batch"])
    token = b.pop("tokens")
    return model.decode, (token, args["cache"], b or None)


def _trace(model, shape: ShapeConfig, mesh, args: dict, microbatches: int) -> StepStats:
    """The cell's step run once inside ``mesh_scope`` under ``analyze_step``."""
    with mesh_scope(mesh):
        step, step_args = cell_step(model, shape, args, microbatches)
        _, stats = analyze_step(step, *step_args)
    return stats


def main(argv: list[str] | None = None) -> list[tuple]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--layout", choices=["tp-fsdp", "fsdp"], default="tp-fsdp")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--no-trace", action="store_true",
                    help="place only: argument bytes and the analytic model (every mesh traces by default)")
    ap.add_argument("--out", default=None, help="directory for one JSON (or .err) a cell; none by default")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its own with one thread (needs --out)")
    args = ap.parse_args(argv)
    if args.jobs > 1 and not args.out:
        ap.error("--jobs needs --out")

    out_dir = Path(args.out) if args.out else None
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
    archs = args.arch or (all_arch_ids() if args.all else ["qwen2-0.5b"])
    suffix = "" if args.layout == "tp-fsdp" else f"--{args.layout}"
    if args.microbatches:
        suffix += f"--mb{args.microbatches}"
    cells = []
    for mesh_name in {"single": ["single"], "multi": ["multi"], "both": ["single", "multi"]}[args.mesh]:
        for arch in archs:
            for shape_id in args.shape or [s.shape_id for s in cells_for(get_config(arch))]:
                path = out_dir / f"{arch}__{shape_id}__{mesh_name}{suffix}.json" if out_dir else None
                if args.skip_existing and path is not None and path.exists():
                    print(f"skip {path.name}")
                    continue
                cells.append((mesh_name, arch, shape_id, path))
    run = _run_in_processes if args.jobs > 1 else _run_here
    summary = run(cells, args)
    print("\n=== dry-run summary ===")
    for row in summary:
        print(f"{row[0]:24s} {row[1]:12s} {row[2]:7s} {row[3]:18s} dominant={row[4]:12s} trace={row[5]}s")
    return summary


def _run_here(cells: list[tuple], args) -> list[tuple]:
    """Each cell traced in this process, a fake process group a mesh."""
    summary = []
    for multi in (False, True):
        mine = [c for c in cells if (c[0] == "multi") == multi]
        if not mine:
            continue
        with fake_process_group(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            for mesh_name, arch, shape_id, path in mine:
                try:
                    res = run_cell(arch, shape_id, mesh, layout=args.layout, microbatches=args.microbatches,
                                   trace=not args.no_trace)
                    if path is not None:
                        path.write_text(json.dumps(res, indent=1))
                    summary.append((arch, shape_id, mesh_name, "OK", res.get("roofline", {}).get("dominant", "-"),
                                    res.get("trace_s", "-")))
                except Exception as e:  # noqa: BLE001 — report, keep going
                    traceback.print_exc()
                    summary.append((arch, shape_id, mesh_name, f"FAIL:{type(e).__name__}", "-", 0))
                    if path is not None:
                        path.with_suffix(".err").write_text(traceback.format_exc())
    return summary


def _run_in_processes(cells: list[tuple], args) -> list[tuple]:
    """Each cell traced by this CLI in a process of its own (one intra-op
    thread, its output in ``<cell>.log`` beside its JSON), ``args.jobs`` at
    a time; a row a cell as it ends. The processes are stopped on exit."""
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")])))
    flags = ["--layout", args.layout, "--out", args.out]
    flags += ["--microbatches", str(args.microbatches)] if args.microbatches else []
    flags += ["--no-trace"] if args.no_trace else []
    pending, running, summary = list(cells), {}, []
    try:
        while pending or running:
            while pending and len(running) < args.jobs:
                mesh_name, arch, shape_id, path = cell = pending.pop(0)
                cmd = [sys.executable, "-m", __spec__.name, "--arch", arch, "--shape", shape_id, "--mesh", mesh_name,
                       *flags]
                with open(path.with_suffix(".log"), "w") as log:
                    running[cell] = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env)
            time.sleep(0.5)
            for cell, proc in list(running.items()):
                if proc.poll() is None:
                    continue
                del running[cell]
                mesh_name, arch, shape_id, path = cell
                if path.exists():
                    res = json.loads(path.read_text())
                    row = (arch, shape_id, mesh_name, "OK", res.get("roofline", {}).get("dominant", "-"),
                           res.get("trace_s", "-"))
                else:
                    row = (arch, shape_id, mesh_name, f"FAIL:rc={proc.returncode}", "-", 0)
                summary.append(row)
                print(f"{row[0]:24s} {row[1]:12s} {row[2]:7s} {row[3]:18s} trace={row[5]}s", flush=True)
    finally:
        for proc in running.values():
            proc.kill()
            proc.wait()
    return summary


if __name__ == "__main__":
    main()
