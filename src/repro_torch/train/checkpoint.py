"""LM-plane step checkpointing (params + optimizer state), in the JAX
package's format.

A checkpoint is a directory: ``params.npz`` and ``opt_state.npz`` keyed by
the reference's flattened tree paths (``embed``, ``layers/attn/wq`` stacked
on the layer axis as ``repro_torch.models.convert.STACKED``,
``master/layers/attn/wq``, ``step``), and ``meta.json`` with ``step``. So a
checkpoint written by either package loads in the other. bf16 leaves are
written as the reference's numpy arrays hold them
(``ml_dtypes.bfloat16``, which ``np.savez`` stores as two raw bytes a
value); a loaded leaf is cast to its target's dtype, and two raw bytes
into a bf16 target are taken as its bits.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..models.convert import _to_numpy, _to_torch, reference_path, to_reference_params
from .optimizer import _named

__all__ = ["save_train_state", "load_train_state"]


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            flat.update(_flatten(val, f"{prefix}{key}/"))
        else:
            flat[f"{prefix}{key}"] = val
    return flat


def _opt_tree(opt_state: dict) -> dict:
    return {"step": _to_numpy(opt_state["step"]),
            **{k: to_reference_params(opt_state[k]) for k in ("master", "m", "v")}}


def save_train_state(
    path: str | Path,
    *,
    params: nn.Module | Mapping[str, torch.Tensor],
    opt_state: dict,
    step: int,
    meta: dict | None = None,
) -> None:
    """Write ``params`` (a ``Model``, or its parameter names to tensors),
    ``opt_state`` (``adamw_init``'s layout) and ``{"step": step, **meta}``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "params.npz", **_flatten(to_reference_params(_named(params))))
    np.savez(path / "opt_state.npz", **_flatten(_opt_tree(opt_state)))
    (path / "meta.json").write_text(json.dumps({"step": step, **(meta or {})}))


def _leaf(flat, key: str, row: int | None, like: torch.Tensor) -> torch.Tensor:
    arr = flat[key]
    arr = arr if row is None else arr[row]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}{'' if row is None else f'[{row}]'}: stored shape {arr.shape}, "
                         f"expected {tuple(like.shape)}")
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2 and like.dtype == torch.bfloat16:
        bits = np.array(arr).view(np.int16)  # repro: host-ok(a numpy array read from the checkpoint's file)
        return torch.from_numpy(bits).view(torch.bfloat16).to(like.device)
    return _to_torch(arr).to(like.device, like.dtype)


def _load_named(flat, like: Mapping[str, torch.Tensor], prefix: str = "") -> dict[str, torch.Tensor]:
    out = {}
    for name, t in like.items():
        path, row = reference_path(name)
        out[name] = _leaf(flat, prefix + "/".join(path), row, t)
    return out


def load_train_state(
    path: str | Path,
    params_like: nn.Module | Mapping[str, torch.Tensor],
    opt_like: dict,
):
    """Restore a checkpoint of either package into the given structures:
    returns (params, opt_state, meta). The parameters of ``params_like`` (a
    ``Model``, or names to tensors) are written in place and it is returned;
    ``opt_state`` is a new dict laid out, typed and placed as ``opt_like``
    (from ``adamw_init``)."""
    path = Path(path)
    named = _named(params_like)
    with np.load(path / "params.npz") as z:  # each stored array read once, not once a row
        p_flat = {k: z[k] for k in z.files}
    with np.load(path / "opt_state.npz") as z:
        o_flat = {k: z[k] for k in z.files}
    loaded = _load_named(p_flat, named)
    opt_state = {"step": _leaf(o_flat, "step", None, opt_like["step"])}
    for k in ("master", "m", "v"):
        opt_state[k] = _load_named(o_flat, opt_like[k], f"{k}/")
    with torch.no_grad():
        for name, t in named.items():
            t.copy_(loaded[name])
    meta = json.loads((path / "meta.json").read_text())
    return params_like, opt_state, meta
