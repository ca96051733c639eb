"""Carry parameters between the JAX package's pytree and the port's ``Model``.

The reference stacks every layer's parameters on a leading layer axis
(``tree["layers"]["attn"]["wq"]`` has shape (L, D, H*hd)), and so it does
whisper's ``encoder`` and ``cross`` trees; the port holds one module a
layer. Every other name and every orientation is the same, so a leaf
``(key, *path)`` of a stacked tree (``STACKED``) row ``i`` is the port's
parameter ``{key}.{i}.{path}`` and any other leaf ``path`` is ``{path}``. The tree
comes as numpy arrays (bfloat16 ones as ``ml_dtypes.bfloat16``, the dtype
JAX hands to numpy); nothing here imports JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..configs.base import ArchConfig
from .zoo import DistContext, Model

__all__ = ["from_reference_params", "to_reference_params", "reference_path", "STACKED"]

# the reference's trees stacked on a leading layer axis
STACKED = ("layers", "encoder", "cross")


def reference_path(name: str) -> tuple[tuple[str, ...], int | None]:
    """Where the port's parameter ``name`` lies in the reference's tree: the
    leaf's path and, for a stacked tree, its row (else None)."""
    parts = tuple(name.split("."))
    if parts[0] in STACKED:
        return (parts[0], *parts[2:]), int(parts[1])
    return parts, None


def _leaves(tree: dict, prefix: tuple = ()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, (*prefix, key))
        else:
            yield (*prefix, key), val


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16: move the bits
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the numpy bfloat16 the reference's arrays use

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_reference_params(
    cfg: ArchConfig,
    tree: dict,
    *,
    device: str | torch.device,
    dtype: torch.dtype | None = None,
) -> Model:
    """The port's ``Model`` holding the reference's parameters ``tree``.
    ``dtype`` is the model's (its weights' and QKV biases') dtype, by default
    that of ``tree["embed"]``; each leaf is cast to its parameter's dtype, so
    with the default every parameter is bitwise its leaf."""
    if dtype is None:
        dtype = _to_torch(tree["embed"]).dtype
    model = Model(cfg, DistContext(), device=torch.device(device), dtype=dtype)
    params = dict(model.named_parameters())
    seen = set()
    for path, leaf in _leaves(tree):
        t = _to_torch(leaf)
        if path[0] in STACKED:
            rows = [(f"{path[0]}.{i}.{'.'.join(path[1:])}", t[i]) for i in range(t.shape[0])]
        else:
            rows = [(".".join(path), t)]
        for name, val in rows:
            if name not in params:
                raise KeyError(f"reference leaf {name} has no parameter in the port's {cfg.arch_id}")
            if tuple(params[name].shape) != tuple(val.shape):
                raise ValueError(f"{name}: reference shape {tuple(val.shape)}, port {tuple(params[name].shape)}")
            with torch.no_grad():
                params[name].copy_(val)
            seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"the reference tree has no leaf for {missing}")
    return model


def to_reference_params(model: Model | Mapping[str, torch.Tensor]) -> dict:
    """The reference's pytree (numpy leaves, layers stacked on a leading
    axis) of ``model``'s parameters, or of a mapping from the model's
    parameter names to tensors (an optimizer's masters or moments): the
    inverse of ``from_reference_params``."""
    named = model.named_parameters() if isinstance(model, Model) else model.items()
    tree: dict = {"final_ln": {}}
    stacked: dict = {}
    for name, p in named:
        path, row = reference_path(name)
        if row is not None:
            stacked.setdefault(path, []).append(_to_numpy(p))
            continue
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _to_numpy(p)
    for path, rows in stacked.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(rows)
    return tree
