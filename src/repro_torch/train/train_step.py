"""serve_step factory: one greedy token against a ring-buffer KV cache."""

from __future__ import annotations

from typing import Callable

import torch

from ..models.zoo import Model

__all__ = ["make_serve_step"]


def make_serve_step(model: Model, *, greedy: bool = True) -> Callable:
    """``serve_step(token, cache, extras=None) -> (next_token, cache)``: the
    first argmax of the last position's logits, as int32 (B, 1). The step
    stays on the model's device and makes no host sync; it writes the
    cache's ``k``/``v`` in place (``Model.decode``)."""
    if not greedy:
        raise NotImplementedError("serve_step decodes greedily; the reference has no sampler either")

    def serve_step(token: torch.Tensor, cache: dict, extras: dict | None = None):
        logits, cache = model.decode(token, cache, extras)
        return logits[:, -1:].argmax(dim=-1).to(torch.int32), cache

    return serve_step
