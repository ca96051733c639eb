"""AdamW with fp32 master weights, on tensors.

The PyTorch twin of the JAX package's ``train/optimizer.py``: the same
configuration, schedule, clip and update, in the reference's order of
operations. The state is a dict: ``step`` (an int32 scalar on the
parameters' device) and ``master``, ``m``, ``v`` (dicts of tensors keyed by
``Model.named_parameters()`` names). Masters and moments are f32 for bf16
and f32 parameters, as in the reference, and f64 for a float64 model
(``acc_dtype``), so that a float64 model trains in float64 throughout.
Compute parameters may be bf16; updates happen on the master, and the
parameter takes the master cast to its dtype, written in place.

``torch.optim.AdamW`` is not this update: it decays the weights before the
Adam step, on the parameter, and has no clip or warmup.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch
from torch import nn

from ..models.layers import acc_dtype

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def _named(params: nn.Module | Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A module's ``named_parameters``, or a mapping of name to tensor as given."""
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def global_norm(tensors: Mapping[str, torch.Tensor | None]) -> torch.Tensor:
    """sqrt of the sum of every tensor's squares, each summed in
    ``acc_dtype`` and added in the mapping's order (a ``None`` adds
    nothing: a zero gradient)."""
    sq = [x.to(acc_dtype(x.dtype)).square().sum() for x in tensors.values() if x is not None]
    return torch.sqrt(sum(sq[1:], sq[0]))


def _schedule(cfg: AdamWConfig, step: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    warm = torch.clamp((step + 1).to(dtype) / max(1, cfg.warmup_steps), max=1.0)
    return cfg.lr * warm


def adamw_init(params: nn.Module | Mapping[str, torch.Tensor]) -> dict:
    """The state for ``params`` (a module, or a mapping of name to tensor):
    step 0, masters copied from the parameters in ``acc_dtype``, zero
    moments."""
    named = _named(params)
    dev = next(iter(named.values())).device
    with torch.no_grad():
        return {
            "step": torch.zeros((), dtype=torch.int32, device=dev),
            "master": {k: p.detach().to(acc_dtype(p.dtype), copy=True) for k, p in named.items()},
            "m": {k: torch.zeros(p.shape, dtype=acc_dtype(p.dtype), device=p.device) for k, p in named.items()},
            "v": {k: torch.zeros(p.shape, dtype=acc_dtype(p.dtype), device=p.device) for k, p in named.items()},
        }


@torch.no_grad()
def adamw_update(
    grads: Mapping[str, torch.Tensor | None],
    opt_state: dict,
    params: nn.Module | Mapping[str, torch.Tensor],
    cfg: AdamWConfig,
) -> tuple[dict, dict, dict]:
    """One AdamW step. Returns (params, new opt state, stats): each
    parameter is written in place with its new master cast to its dtype,
    and the returned params are the same tensors. ``grads`` maps every
    parameter name to its gradient, or to ``None`` for a parameter that took
    no part in the loss, which is updated with a zero gradient (decay still
    applies), as the reference's zero gradient is. ``stats`` holds
    ``grad_norm`` (before clipping) and ``lr``, device scalars: the step
    makes no host sync."""
    named = _named(params)
    hi = next(iter(opt_state["master"].values())).dtype
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    # a tensor numerator: ``float / tensor`` is a reciprocal times the float
    scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip) / (gnorm + 1e-9), max=1.0)
    lr = _schedule(cfg, opt_state["step"], hi)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(hi)
    bc2 = 1.0 - b2 ** step.to(hi)
    new = {"step": step, "m": {}, "v": {}, "master": {}}
    for name, p in named.items():
        m, v, master = opt_state["m"][name], opt_state["v"][name], opt_state["master"][name]
        g = grads.get(name)
        g = torch.zeros_like(master) if g is None else g.to(master.dtype) * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * master
        master_new = master - lr * delta
        p.copy_(master_new.to(p.dtype))
        new["m"][name], new["v"][name], new["master"][name] = m_new, v_new, master_new
    return named, new, {"grad_norm": gnorm, "lr": lr}
