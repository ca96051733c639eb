"""Mixture-of-Experts layer with capacity-based top-k routing, on torch.

The PyTorch twin of the JAX package's ``models/moe.py``. Tokens are routed
within token groups (``n_token_groups``; 1 on one device and in decode):
an f32 router softmax, top-k, gates renormalised with a 1e-9 floor, then a
token-major cumsum gives each (token, choice) its position in its expert,
and a choice whose position reaches the capacity ``C`` is dropped. Kept
choices are scattered into a static (G, E, C, D) dispatch tensor, the
SwiGLU experts run as batched products over it, and the outputs are
gathered back and weighted by the gates. Every shape is fixed by the
config and the token count, so the layer makes no host sync.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from .layers import acc_dtype

__all__ = ["moe_capacity", "moe_layer"]


def moe_capacity(tokens_per_group: int, n_experts: int, top_k: int, capacity_factor: float) -> int:
    cap = int(tokens_per_group * top_k * capacity_factor / n_experts)
    return max(4, min(tokens_per_group, cap))


def _route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """The router of ``x`` (..., D): (probs (..., E), gates (..., K)
    renormalised, expert ids (..., K)), the softmax in f32 (f64 for an f64
    model) and the top k in descending order."""
    acc = acc_dtype(x.dtype)
    probs = torch.softmax(x.to(acc) @ router.to(acc), dim=-1)
    gate, expert_idx = torch.topk(probs, top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate, expert_idx


def _dispatch(xf: torch.Tensor, expert_idx: torch.Tensor, E: int, C: int):
    """Tokens (G, Tg, D) and their expert ids (G, Tg, K) -> the (G, E, C, D)
    dispatch tensor, each choice's flat row in it (G*Tg*K,) and whether the
    choice was kept (G, Tg*K), in the tokens' dtype."""
    G, Tg, D = xf.shape
    K = expert_idx.shape[-1]
    # position-in-expert via a cumsum over the (group-local) token axis,
    # token-major and K minor; the one-hot is a comparison (no class check)
    flat_e = expert_idx.reshape(G, Tg * K)
    experts = torch.arange(E, device=xf.device)
    onehot = (flat_e[..., None] == experts).to(torch.int32)  # (G, Tg*K, E)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos_in_e = torch.gather(pos, 2, flat_e[..., None])[..., 0]  # (G, Tg*K)
    keep = (pos_in_e < C).to(xf.dtype)

    # scatter-dispatch into (G, E, C, D): one flat row per (group, expert,
    # slot). Kept choices own distinct rows; a dropped one adds zero to its
    # expert's last row, so the adds give the reference's scatter exactly
    # in any order
    pos_clip = torch.clamp(pos_in_e, max=C - 1)
    groups = torch.arange(G, device=xf.device)[:, None]
    rows = ((groups * E + flat_e) * C + pos_clip).reshape(-1)
    x_rep = torch.repeat_interleave(xf, K, dim=1)  # (G, Tg*K, D)
    disp = torch.zeros((G * E * C, D), dtype=xf.dtype, device=xf.device)
    disp.index_add_(0, rows, (x_rep * keep[..., None]).reshape(-1, D))
    return disp.reshape(G, E, C, D), rows, keep


def _combine(out_e: torch.Tensor, rows: torch.Tensor, keep: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """The experts' outputs (G, E, C, D) gathered back to each choice and
    weighted by its renormalised gate: (G, Tg, D)."""
    G, E, C, D = out_e.shape
    Tg, K = gate.shape[1:]
    back = out_e.reshape(G * E * C, D).index_select(0, rows).reshape(G, Tg * K, D)
    back = back * (keep * gate.reshape(G, Tg * K).to(keep.dtype))[..., None]
    return back.reshape(G, Tg, K, D).sum(dim=2)


def moe_layer(
    x: torch.Tensor,  # (B, S, D)
    p,
    *,
    n_experts: int,
    top_k: int,
    capacity_factor: float,
    n_token_groups: int = 1,
    expert_parallel: bool = False,
    wsc=None,
    routes: list | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,D), aux load-balancing loss scalar). With a list
    ``routes``, appends the expert ids each token chose, (B, S, K) on the
    device (no host sync): what a check needs to tell a routing flip at a
    near-tie from an arithmetic error."""
    B, S, D = x.shape
    T = B * S
    G = n_token_groups if T % max(1, n_token_groups) == 0 else 1
    Tg = T // G
    E, K = n_experts, top_k
    C = moe_capacity(Tg, E, K, capacity_factor)
    wsc = wsc or (lambda a, dims: a)

    xf = wsc(x.reshape(G, Tg, D), "b..")
    probs, gate, expert_idx = _route(xf, p["router"], K)  # (G, Tg, E), (G, Tg, K) x2
    if routes is not None:
        routes.append(expert_idx.reshape(B, S, K))

    if isinstance(xf, DTensor):
        # DTensor has no sharding rule for the index operations of the
        # dispatch and the combine (repeat_interleave, index_add_,
        # index_select): each rank runs them on a replicated copy of their
        # operands, and the expert products between them are sharded again
        rep = (Replicate(),) * xf.device_mesh.ndim
        dispatch = local_map(_dispatch, out_placements=(rep, rep, rep), in_placements=(rep, rep, None, None),
                             redistribute_inputs=True)
        combine = local_map(_combine, out_placements=(rep,), in_placements=(rep, rep, rep, rep),
                            redistribute_inputs=True)
    else:
        dispatch, combine = _dispatch, _combine
    disp, rows, keep = dispatch(xf, expert_idx, E, C)
    disp = wsc(disp, "b...")

    # expert FFN (SwiGLU), expert dim leading
    h = F.silu(torch.einsum("gecd,edf->gecf", disp, p["w_gate"])) * torch.einsum(
        "gecd,edf->gecf", disp, p["w_up"]
    )
    h = wsc(h, "b..." if expert_parallel else "b..m")
    out_e = wsc(torch.einsum("gecf,efd->gecd", h, p["w_down"]), "b...")
    y = combine(out_e, rows, keep, gate).reshape(B, S, D)

    # auxiliary load-balancing loss (Switch): E * sum_e f_e * p_e
    experts = torch.arange(E, device=x.device)
    frac = (expert_idx[..., 0, None] == experts).to(probs.dtype).mean(dim=(0, 1))
    mean_prob = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac * mean_prob)
    return y, aux
