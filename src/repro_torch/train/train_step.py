"""train_step / serve_step factories.

``make_train_step`` is the twin of the JAX package's: autograd for
``value_and_grad``, a Python loop over microbatches for its ``lax.scan``;
the step updates the model's parameters in place. ``make_serve_step``
decodes one greedy token against a ring-buffer KV cache.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from ..models.zoo import Model
from .optimizer import AdamWConfig, adamw_update

__all__ = ["make_train_step", "make_serve_step"]


def _grads(model: Model, batch: dict) -> tuple[torch.Tensor, dict]:
    """``model.loss(batch)`` and every parameter's gradient (``None`` for a
    parameter that takes no part in the loss), the parameters' ``.grad``
    left cleared."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    loss, _ = model.loss(batch)
    loss.backward()
    grads = {name: p.grad for name, p in params.items()}
    for p in params.values():
        p.grad = None
    return loss.detach(), grads


def _rows(x: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """Rows ``start:stop`` of ``x``. DTensor returns the rows of a batch
    sharded on them replicated: they are sharded again as the batch was."""
    part = x[start:stop]
    if isinstance(part, DTensor):
        part = part.redistribute(x.device_mesh, x.placements)
    return part


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig,
    *,
    microbatches: int = 1,
) -> Callable:
    """Build ``train_step(opt_state, batch) -> (opt_state, metrics)``, which
    writes ``model``'s parameters in place (``adamw_update``).

    ``batch`` is a dict of tensors on the model's device (``tokens`` and
    ``labels``, (B, S)). With ``microbatches > 1`` the global batch is split
    on the leading axis and gradients are accumulated in f32 (``acc_dtype``)
    as ``g_acc + g / microbatches``, microbatch by microbatch, and so is the
    loss, bounding peak activation memory to one microbatch regardless of the
    global batch. With one microbatch the gradients stay in the parameters'
    dtype. ``metrics``: ``loss``, ``grad_norm`` and ``lr``, device scalars
    (the reference's step returns these, and drops ``Model.loss``'s own
    metrics). The step makes no host sync.
    """

    def train_step(opt_state: dict, batch: dict):
        if microbatches == 1:
            loss, grads = _grads(model, batch)
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % microbatches:
                raise ValueError(f"a batch of {rows} rows does not split into {microbatches} microbatches")
            n = rows // microbatches
            mbs = [{k: _rows(x, i * n, (i + 1) * n) for k, x in batch.items()} for i in range(microbatches)]
            g_acc = {k: torch.zeros_like(m) for k, m in opt_state["master"].items()}
            loss = 0.0
            for mb in mbs:
                mb_loss, g = _grads(model, mb)
                for k, gk in g.items():
                    if gk is not None:
                        g_acc[k] = g_acc[k] + gk.to(g_acc[k].dtype) / microbatches
                loss = loss + mb_loss / microbatches
            grads = g_acc
        _, opt_state, stats = adamw_update(grads, opt_state, model, opt_cfg)
        return opt_state, {"loss": loss, **stats}

    return train_step


def make_serve_step(model: Model, *, greedy: bool = True) -> Callable:
    """``serve_step(token, cache, extras=None) -> (next_token, cache)``: the
    first argmax of the last position's logits, as int32 (B, 1). The step
    stays on the model's device, builds no autograd graph and makes no host
    sync; it writes the cache's ``k``/``v`` in place (``Model.decode``, which
    runs under ``torch.no_grad``)."""
    if not greedy:
        raise NotImplementedError("serve_step decodes greedily; the reference has no sampler either")

    def serve_step(token: torch.Tensor, cache: dict, extras: dict | None = None):
        logits, cache = model.decode(token, cache, extras)
        return logits[:, -1:].argmax(dim=-1).to(torch.int32), cache

    return serve_step
