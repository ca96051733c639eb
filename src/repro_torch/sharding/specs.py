"""Sharding rules for all architectures and input shapes, on torch.

The twin of the JAX package's ``sharding/specs.py``: the same rules, the
same constants and names. Baseline layout = TP ("model" axis) x FSDP
("data" axis) x pure DP ("pod"):

* every weight matrix is sharded on "model" along its parallel dimension
  (column-parallel in, row-parallel out — Megatron style) *and* on "data"
  along the other dimension (FSDP storage sharding);
* the "pod" axis only shards the batch: parameters are replicated across
  pods, so gradient all-reduces are the only inter-pod collectives;
* optimizer state (fp32 master + moments) inherits the parameter specs —
  with FSDP params this is full ZeRO sharding;
* MoE experts: expert dim on "model" when divisible (true EP: granite-moe
  32e/16) else d_ff on "model" (TP inside each expert: mixtral 8e/16);
* KV caches: batch on ("pod","data"), kv-heads on "model" — except
  ``long_500k`` (batch=1) where the *sequence* dim is sharded on
  ("pod","data") and decode becomes a distributed flash-decode.

A spec is a plain tuple with one entry per tensor dimension: ``None``, an
axis name, or a tuple of axis names (``tuple(PartitionSpec)`` of the
reference, padded to the tensor's rank). ``_sanitize`` drops every axis
that does not divide its dimension, so no parameter or cache spec shards
unevenly. Parameter specs are keyed by the port's
``Model.named_parameters()`` names; each leaf's rule is found at its
reference path (``repro_torch.models.convert.reference_path``). The port
holds one module a layer of a stacked tree (``layers``, ``encoder``,
``cross``), so its leaf's spec is the reference's without the leading
layer entry. ``to_placements`` turns a spec into ``torch.distributed.tensor``
placements on a ``DeviceMesh``.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..configs.base import ArchConfig
from ..configs.shapes import ShapeConfig
from ..models.convert import reference_path

__all__ = [
    "param_pspecs",
    "batch_pspecs",
    "cache_pspecs",
    "opt_state_pspecs",
    "BATCH_AXES",
    "to_placements",
    "place",
    "place_tree",
    "place_model",
]

BATCH_AXES = ("pod", "data")  # present axes are filtered per mesh

Spec = tuple


def _ax(mesh_axes: tuple[str, ...], *names: str):
    """Axis tuple filtered to the axes the mesh actually has."""
    present = tuple(n for n in names if n in mesh_axes)
    if not present:
        return None
    return present if len(present) > 1 else present[0]


# default production-mesh axis sizes; callers pass the real ones
DEFAULT_AXIS_SIZES = {"pod": 2, "data": 16, "model": 16}


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _sanitize(spec: Spec, shape: tuple[int, ...], axis_sizes: dict[str, int]) -> Spec:
    """Drop axes that do not divide their dimension (the tensor is then
    replicated over them), as the reference must for explicit shardings."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            out.append(None)
            continue
        prod = 1
        for n in _names(entry):
            prod *= axis_sizes.get(n, 1)
        out.append(entry if prod and dim % prod == 0 else None)
    return tuple(out)


# -- parameters ---------------------------------------------------------------

_COL_IN = {  # (D_in, X_out): in-dim FSDP, out-dim TP
    "wq", "wk", "wv", "w_gate", "w_up", "w_ck", "w_cr", "w_r", "w_k", "w_v",
    "w_g", "in_proj", "w_lora_a",
}
_ROW_OUT = {"wo", "w_down", "w_cv", "out_proj", "w_o", "w_lora_b"}
_REPLICATED = {
    "scale", "bias", "A_log", "D_skip", "dt_bias", "norm_scale", "u", "w0",
    "ln_x_scale", "ln_x_bias", "conv_b", "mu_r", "mu_k", "mu_v", "mu_g",
    "mu_w", "mu_ck", "mu_cr",
}


def _leaf_spec(
    cfg: ArchConfig, names: tuple[str, ...], ndim: int, mesh_axes, fsdp: bool = True,
    layout: str = "tp-fsdp",
) -> Spec:
    """The reference's rule for the leaf at path ``names`` of ``ndim``
    dimensions (a stacked leaf's ``ndim`` counts its layer axis)."""
    name = names[-1]
    stacked = any(n in ("layers", "encoder", "cross") for n in names)
    lead = (None,) if stacked else ()
    # fsdp=False (serving layout): params replicated over "data"
    data = _ax(mesh_axes, "data") if fsdp else None
    model = _ax(mesh_axes, "model")
    if layout == "fsdp":
        # pure-FSDP layout: no tensor parallelism; the model axis becomes a
        # second data axis
        data = _ax(mesh_axes, "data", "model") if fsdp else None
        model = None

    def pad(spec_tail: tuple) -> Spec:
        tail = lead + spec_tail
        assert len(tail) == ndim, (names, ndim, tail)
        return tail

    if name == "embed":
        return (model, data)
    if name == "head":
        return (data, model)
    if name == "router":
        return pad((data, None))
    if "moe" in names and name in ("w_gate", "w_up"):
        if cfg.n_experts % 16 == 0:  # expert parallelism
            return pad((model, data, None))
        return pad((None, data, model))  # TP inside experts
    if "moe" in names and name == "w_down":
        if cfg.n_experts % 16 == 0:
            return pad((model, None, data))
        return pad((None, model, data))
    if name == "conv_w":
        return pad((None, model))
    if name in ("bq", "bk", "bv"):
        return pad((model,))
    if name in _REPLICATED:
        return pad((None,) * (ndim - len(lead)))
    if name in _COL_IN:
        return pad((data, model))
    if name in _ROW_OUT:
        return pad((model, data))
    # fallback: replicate
    return (None,) * ndim


def _param_spec(cfg, name: str, shape, mesh_axes, sizes, fsdp: bool, layout: str) -> Spec:
    """The port's parameter ``name`` of ``shape``: the reference's spec of
    its leaf, without the layer entry of a stacked leaf."""
    path, row = reference_path(name)
    ref_shape = tuple(shape) if row is None else (1, *shape)
    spec = _sanitize(_leaf_spec(cfg, path, len(ref_shape), mesh_axes, fsdp, layout), ref_shape, sizes)
    return spec if row is None else spec[1:]


def _shapes(named) -> Iterable[tuple[str, tuple[int, ...]]]:
    items = named.named_parameters() if hasattr(named, "named_parameters") else named.items()
    return ((name, tuple(t.shape)) for name, t in items)


def param_pspecs(
    cfg: ArchConfig,
    params,
    mesh_axes: tuple[str, ...],
    axis_sizes: dict[str, int] | None = None,
    fsdp: bool = True,
    layout: str = "tp-fsdp",
) -> dict[str, Spec]:
    """``{name: spec}`` for a ``Model`` (or a mapping of its parameter names
    to tensors)."""
    sizes = axis_sizes or DEFAULT_AXIS_SIZES
    return {name: _param_spec(cfg, name, shape, mesh_axes, sizes, fsdp, layout) for name, shape in _shapes(params)}


def opt_state_pspecs(
    cfg: ArchConfig,
    opt_state: Mapping,
    mesh_axes: tuple[str, ...],
    axis_sizes: dict[str, int] | None = None,
    layout: str = "tp-fsdp",
) -> dict:
    """Optimizer state (``adamw_init``'s layout): step replicated;
    master/m/v inherit the parameter specs with ``fsdp=True``."""
    sizes = axis_sizes or DEFAULT_AXIS_SIZES
    out: dict = {"step": ()}
    for key in ("master", "m", "v"):
        out[key] = {name: _param_spec(cfg, name, shape, mesh_axes, sizes, True, layout)
                    for name, shape in _shapes(opt_state[key])}
    return out


# -- batches ---------------------------------------------------------------------


def batch_pspecs(cfg: ArchConfig, shape: ShapeConfig, mesh_axes, layout: str = "tp-fsdp") -> dict:
    b = _ax(mesh_axes, "pod", "data") if layout != "fsdp" else _ax(mesh_axes, "pod", "data", "model")
    model = _ax(mesh_axes, "model") if layout != "fsdp" else None
    out: dict[str, Spec] = {"tokens": (b, None), "labels": (b, None)}
    if shape.kind == "decode":
        if shape.global_batch == 1:
            out = {"tokens": (None, None), "labels": (None, None)}
    if cfg.m_rope:
        out["positions"] = (out["tokens"][0], None, None)
        out["frontend_embeds"] = (out["tokens"][0], None, model)
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = (out["tokens"][0], None, model)
    return out


# -- caches -----------------------------------------------------------------------


def cache_pspecs(
    cfg: ArchConfig,
    shape: ShapeConfig,
    cache: Mapping,
    mesh_axes,
    axis_sizes: dict[str, int] | None = None,
) -> dict:
    """Spec dict matching ``init_cache``'s structure."""
    sizes = axis_sizes or DEFAULT_AXIS_SIZES
    bax = _ax(mesh_axes, "pod", "data")
    model = _ax(mesh_axes, "model")
    seq_shard = shape.global_batch == 1  # long_500k: shard the KV sequence

    model_size = sizes.get("model", 1)

    def spec(name: str, ndim: int) -> Spec:
        if name == "pos":
            return ()
        if name in ("k", "v", "ek", "ev"):  # (L, B, T, Hkv, hd)
            if seq_shard:
                return (None, None, bax, model, None)
            if cfg.n_kv % max(model_size, 1) == 0:
                return (None, bax, None, model, None)
            # kv heads do not divide the model axis: shard the cache
            # *sequence* dim on it instead (distributed flash-decode)
            return (None, bax, model, None, None)
        if name == "conv":  # (L, B, K-1, conv_dim)
            return (None, bax if not seq_shard else None, None, model)
        if name == "ssm":  # (L, B, H, N, P)
            return (None, bax if not seq_shard else None, model, None, None)
        if name == "wkv":  # (L, B, H, hd, hd)
            return (None, bax if not seq_shard else None, model, None, None)
        if name in ("shift_t", "shift_c"):  # (L, B, D)
            return (None, bax if not seq_shard else None, None)
        return (None,) * ndim

    def walk(tree: Mapping) -> dict:
        return {k: walk(v) if isinstance(v, Mapping) else _sanitize(spec(k, v.dim()), tuple(v.shape), sizes)
                for k, v in tree.items()}

    return walk(cache)


# -- placements -------------------------------------------------------------------


def to_placements(spec: Spec, mesh) -> list:
    """``torch.distributed.tensor`` placements of ``spec`` on ``mesh``: for
    each mesh dimension, ``Shard(d)`` where tensor dimension ``d`` names its
    axis, else ``Replicate()``. A dimension named by several axis names is
    sharded on each of them, in the mesh's order, which must be the order
    the entry names them in: the shard order is then the reference's
    major-to-minor one. An axis of size 1 holds the whole tensor, so it
    replicates (DTensor's view rules refuse to drop a size-1 dimension
    sharded on it)."""
    axes = tuple(mesh.mesh_dim_names)
    placements = [Replicate() for _ in axes]
    for d, entry in enumerate(spec):
        names = _names(entry)
        idx = [axes.index(n) for n in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names its axes out of the mesh's order {axes}")
        for i in idx:
            if mesh.shape[i] > 1:
                placements[i] = Shard(d)
    return placements


def _local_slices(shape: tuple[int, ...], spec: Spec, mesh) -> list[slice]:
    """This rank's block of a tensor of ``shape`` placed by ``spec``: each
    dimension split into the product of its axes' sizes, the block indexed
    major-to-minor by this rank's coordinates on those axes. Every split
    must be even, as the reference's explicit shardings must."""
    axes = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    out = []
    for d, dim in enumerate(shape):
        names = _names(spec[d]) if d < len(spec) else ()
        parts, index = 1, 0
        for n in names:
            size = mesh.shape[axes.index(n)]
            parts, index = parts * size, index * size + coord[axes.index(n)]
        if dim % parts:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not divide over {spec[d]!r} ({parts} ranks)")
        step = dim // parts
        out.append(slice(index * step, (index + 1) * step))
    return out


def place(t: torch.Tensor, spec: Spec, mesh) -> DTensor:
    """``t`` (the whole tensor, the same on every rank) as a DTensor on
    ``mesh`` placed by ``spec``: each rank keeps its own block, with no
    collective, so a meta tensor places as well as a real one."""
    local = t.detach()[tuple(_local_slices(tuple(t.shape), spec, mesh))].contiguous()
    return DTensor.from_local(local, mesh, to_placements(spec, mesh), run_check=False,
                              shape=t.shape, stride=t.contiguous().stride())


def place_tree(tree: Mapping, specs: Mapping, mesh) -> dict:
    """``place`` over a nested dict of tensors and its matching specs."""
    return {k: place_tree(v, specs[k], mesh) if isinstance(v, Mapping) else place(v, specs[k], mesh)
            for k, v in tree.items()}


def place_model(model, specs: Mapping[str, Spec], mesh):
    """Swap every parameter of ``model`` for a DTensor parameter placed by
    ``specs[name]`` (``param_pspecs``), keeping its ``init_rule``."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        new = torch.nn.Parameter(place(p, specs[name], mesh), requires_grad=p.requires_grad)
        new.init_rule = getattr(p, "init_rule", None)
        setattr(model.get_submodule(owner), leaf, new)
    return model
