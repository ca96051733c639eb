"""Worker processes of the port's distribution tests: each runs as one rank
of a gloo process group on the CPU, started by ``spawn`` (imports no jax).

``run_ranks`` starts ``world`` ranks of ``fn(rank, world, out_dir, *args)``
with ``init_method="file://..."`` in ``out_dir`` and waits for all of them;
rank 0 writes its findings with ``torch.save`` to ``out_dir / "rank0.pt"``.
"""

from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["run_ranks", "flash_decode_rank", "active_model_rank", "fixed_placements_rank"]


def _init(rank: int, world: int, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/pg", world_size=world, rank=rank)


def run_ranks(fn, world: int, out_dir: Path, *args) -> dict:
    """Run ``fn`` on ``world`` gloo ranks; rank 0's saved dict."""
    mp.start_processes(fn, args=(world, str(out_dir), *args), nprocs=world, start_method="spawn", join=True)
    return torch.load(out_dir / "rank0.pt")


def flash_decode_rank(rank: int, world: int, out_dir: str, inputs: dict) -> None:
    """``sharded_decode_attention`` over this rank's slice of T, in f32 and
    f64; rank 0 saves both (the same on every rank)."""
    from repro_torch.models.attention import sharded_decode_attention

    _init(rank, world, out_dir)
    try:
        out = {}
        for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            q, k, v = (inputs[n].to(dtype) for n in ("q", "k", "v"))
            T = k.shape[1] // world
            mine = slice(rank * T, (rank + 1) * T)
            out[name] = sharded_decode_attention(q, k[:, mine], v[:, mine])
        if rank == 0:
            torch.save(out, Path(out_dir) / "rank0.pt")
    finally:
        dist.destroy_process_group()


def active_model_rank(rank: int, world: int, out_dir: str, archs: list[str], shape: tuple = (2, 2)) -> None:
    """For each reduced arch: the model with an active ``DistContext`` on a
    ``shape`` mesh, ("data", "model") or, with three axes, ("pod", "data",
    "model") (the batch sharded over "pod" and "data"), parameters placed by
    ``param_pspecs``, against the same weights with an inactive context (the
    same token groups): the loss, every gradient and 4 greedy decode steps.
    Rank 0 saves each arch's largest differences."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.mesh import mesh_axis_sizes, mesh_scope
    from repro_torch.models import build_model
    from repro_torch.models.zoo import DistContext
    from repro_torch.sharding.specs import batch_pspecs, cache_pspecs, param_pspecs, place, place_model, place_tree

    _init(rank, world, out_dir)
    try:
        axes = ("pod", "data", "model")[-len(shape):]
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        sizes = mesh_axis_sizes(mesh)
        groups = world // sizes["model"]
        found = {}
        for arch in archs:
            cfg = get_config(arch).reduced()
            plain = build_model(cfg, DistContext(n_token_groups=groups), device="cpu",
                                generator=torch.Generator().manual_seed(0))
            active = build_model(cfg, DistContext(n_token_groups=groups, batch_axes=axes[:-1], model_axis="model",
                                                  model_size=sizes["model"]), device="cpu")
            active.load_state_dict(plain.state_dict())
            place_model(active, param_pspecs(cfg, active, axes, sizes), mesh)
            g = torch.Generator().manual_seed(1)
            batch = {k: torch.randint(0, cfg.vocab, (4, 16), generator=g) for k in ("tokens", "labels")}
            b_spec = batch_pspecs(cfg, SHAPES["train_4k"], axes)
            want, _ = plain.loss(batch)
            want.backward()
            with mesh_scope(mesh):
                got, _ = active.loss({k: place(x, b_spec[k], mesh) for k, x in batch.items()})
                got.backward()
            grad_rel = 0.0
            for (name, a), p in zip(active.named_parameters(), plain.parameters()):
                assert (a.grad is None) == (p.grad is None), name
                if p.grad is not None:
                    err = float((a.grad.full_tensor() - p.grad).abs().max())
                    grad_rel = max(grad_rel, err / max(float(p.grad.abs().max()), 1e-30))
            cache = plain.init_cache(4, 8)
            placed = place_tree({k: v.clone() for k, v in cache.items()},
                                cache_pspecs(cfg, SHAPES["decode_32k"], cache, axes, sizes), mesh)
            t_spec = batch_pspecs(cfg, SHAPES["decode_32k"], axes)["tokens"]
            tok, decode_err = batch["tokens"][:, :1], 0.0
            for _ in range(4):
                want_logits, cache = plain.decode(tok, cache)
                with mesh_scope(mesh):
                    got_logits, placed = active.decode(place(tok, t_spec, mesh), placed)
                decode_err = max(decode_err, float((got_logits.full_tensor() - want_logits).abs().max()))
                tok = want_logits[:, -1:].argmax(dim=-1)
            found[arch] = dict(loss=float(want), loss_err=abs(float(got.detach().full_tensor()) - float(want)), grad_rel=grad_rel,
                               decode_err=decode_err, logits_max=float(want_logits.abs().max()))
        if rank == 0:
            torch.save(found, Path(out_dir) / "rank0.pt")
    finally:
        dist.destroy_process_group()


def _placed(spec: str):
    """Placements from a string a mesh axis: ``R``, ``S<dim>``."""
    from torch.distributed.tensor import Replicate, Shard

    return [Replicate() if p == "R" else Shard(int(p[1:])) for p in spec.split(",")]


def fixed_placements_rank(rank: int, world: int, out_dir: str, cases: dict) -> None:
    """Each case on a (2, 2, 2) ("pod", "data", "model") mesh inside
    ``mesh_scope`` (the fixed placements of
    ``repro_torch.sharding.fixed_placements``), in f64: its operands, made
    from a seed, placed by their spec strings (one entry a mesh axis), then
    a chain of steps, each ``("view", shape)`` or ``("@", i, shape)``, a
    product with operand ``i`` (viewed as ``shape`` first where it is not
    None). Rank 0 saves, a case, the result's placements and its largest
    difference from the same steps on the whole tensors."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import mesh_scope

    _init(rank, world, out_dir)
    try:
        mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
        g = torch.Generator().manual_seed(0)
        found = {}
        for name, (operands, steps) in cases.items():
            whole = [torch.randn(shape, generator=g, dtype=torch.float64) for shape, _ in operands]
            placed = [distribute_tensor(w, mesh, _placed(spec)) for w, (_, spec) in zip(whole, operands)]
            want, got = whole[0], placed[0]
            with mesh_scope(mesh):
                for op, *arg in steps:
                    if op == "view":
                        want, got = want.view(arg[0]), got.view(arg[0])
                        continue
                    i, shape = arg
                    w, p = (whole[i], placed[i]) if shape is None else (whole[i].view(shape), placed[i].view(shape))
                    want, got = want @ w, got @ p
            found[name] = dict(placements=[str(p) for p in got.placements],
                               err=float((got.full_tensor() - want).abs().max()), scale=float(want.abs().max()))
        if rank == 0:
            torch.save(found, Path(out_dir) / "rank0.pt")
    finally:
        dist.destroy_process_group()
