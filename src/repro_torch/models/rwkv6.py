"""RWKV-6 "Finch" block, on torch: time-mix with data-dependent per-channel
decay, and channel-mix.

The PyTorch twin of the JAX package's ``models/rwkv6.py``. The WKV
recurrence ``S_t = diag(w_t) S_{t-1} + k_t^T v_t`` with
``y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)`` keeps the reference's two-level
scan and its order of accumulation:

* an *intra-chunk* scan over the positions of chunks of 64 (the sequence
  padded to a whole number of chunks), vectorized over all chunks and
  heads, each chunk starting from a zero state;
* an *inter-chunk* scan over the chunk-end states, the carried state
  decayed by each chunk's total decay, emitting the state each chunk
  starts from; a position then reads that state through its decay from
  the chunk's start, ``exp(cum_{t-1})``.

A factored exp-of-cumsum form is not used: its one-sided exponents
overflow f32 for data-dependent decays. Decode carries the (heads, hd, hd)
state and the previous token of each mix, O(1) a token. The recurrence
runs in f32 (f64 for an f64 model) whatever the model dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import acc_dtype, reshape_heads

__all__ = [
    "rwkv6_time_mix",
    "rwkv6_channel_mix",
    "rwkv6_init_cache",
    "rwkv6_time_mix_step",
    "rwkv6_channel_mix_step",
]


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """x_{t-1} (zeros / ``prev`` for the first position)."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _mix_inputs(x: torch.Tensor, xs: torch.Tensor, p) -> dict:
    out = {}
    for name in ("r", "k", "v", "g", "w"):
        mu = p[f"mu_{name}"].to(x.dtype)
        out[name] = x + mu * (xs - x)
    return out


def _decay(xw: torch.Tensor, p) -> torch.Tensor:
    """Data-dependent log-decay, per channel and token:
    ``-exp(w0 + tanh(x @ A) @ B)`` <= 0, in f32 (f64 for an f64 model)."""
    acc = acc_dtype(xw.dtype)
    lora = torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]
    return -torch.exp(p["w0"].to(acc) + lora.to(acc))


def _group_norm(y: torch.Tensor, p, H: int, hd: int) -> torch.Tensor:
    """Per-head norm of the WKV output (eps 64e-5), then its scale and bias."""
    mean = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 64e-5)
    return y * p["ln_x_scale"].reshape(H, hd).to(y.dtype) + p["ln_x_bias"].reshape(H, hd).to(y.dtype)


def rwkv6_time_mix(
    x: torch.Tensor,  # (B, S, D)
    p,
    *,
    n_heads: int,
    head_dim: int,
    chunk: int = 64,
    shift_prev: torch.Tensor | None = None,
    wsc=None,
) -> torch.Tensor:
    B, S, D = x.shape
    H, hd = n_heads, head_dim
    acc = acc_dtype(x.dtype)
    wsc = wsc or (lambda a, dims: a)
    xs = _token_shift(x, shift_prev)
    m = _mix_inputs(x, xs, p)
    r = wsc(reshape_heads(m["r"] @ p["w_r"], (B, S, H, hd)), "b.m.").to(acc)
    k = wsc(reshape_heads(m["k"] @ p["w_k"], (B, S, H, hd)), "b.m.").to(acc)
    v = wsc(reshape_heads(m["v"] @ p["w_v"], (B, S, H, hd)), "b.m.").to(acc)
    g = F.silu(m["g"] @ p["w_g"])
    logw = wsc(reshape_heads(_decay(m["w"], p), (B, S, H, hd)), "b.m.")
    u = p["u"].to(acc)  # (H, hd)

    L = min(chunk, S)
    pad = -S % L
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, logw))
    nc = (S + pad) // L
    rc = r.reshape(B, nc, L, H, hd)
    kc = k.reshape(B, nc, L, H, hd)
    vc = v.reshape(B, nc, L, H, hd)
    logw = logw.reshape(B, nc, L, H, hd)
    wc = torch.exp(logw)  # decays in (0, 1]

    # -- intra-chunk scan over positions (vectorized over B, nc, H) ----------
    S_state = torch.zeros((B, nc, H, hd, hd), dtype=acc, device=x.device)
    y_intra = []
    uu = u[None, None, :, :, None]
    for t in range(L):
        r_t, k_t, v_t, w_t = rc[:, :, t], kc[:, :, t], vc[:, :, t], wc[:, :, t]  # (B,nc,H,hd)
        kv = k_t[..., :, None] * v_t[..., None, :]  # (B,nc,H,hd,hd)
        y_intra.append((r_t[..., None, :] @ (S_state + uu * kv))[..., 0, :])
        S_state = S_state * w_t[..., None] + kv
    y_intra = torch.stack(y_intra, dim=2)  # (B,nc,L,H,hd)
    # S_state now holds each chunk's end state accumulated from zero: the
    # recurrence is linear, so the carried part is added separately

    # -- inter-chunk scan over chunk states -----------------------------------
    cum_w = torch.cumsum(logw, dim=2)  # (B,nc,L,H,hd)
    total_decay = torch.exp(cum_w[:, :, -1])  # (B,nc,H,hd)
    Hs = torch.zeros((B, H, hd, hd), dtype=acc, device=x.device)
    H_prev = []
    for c in range(nc):
        H_prev.append(Hs)
        Hs = Hs * total_decay[:, c, ..., None] + S_state[:, c]
    H_prev = torch.stack(H_prev, dim=1)  # (B,nc,H,hd,hd)
    # carried contribution: r_t decayed from chunk start attends H_prev
    decay_from_start = torch.exp(cum_w - logw)  # exp(cum_{t-1})
    r_dec = (rc * decay_from_start).permute(0, 1, 3, 2, 4)  # (B,nc,H,L,hd)
    y_inter = (r_dec @ H_prev).permute(0, 1, 3, 2, 4)  # (B,nc,L,H,hd)

    y = (y_intra + y_inter).reshape(B, S + pad, H, hd)[:, :S]
    y = _group_norm(y, p, H, hd)
    y = wsc(y.reshape(B, S, D), "b.m").to(x.dtype) * g.to(x.dtype)
    return y @ p["w_o"]


def rwkv6_channel_mix(x: torch.Tensor, p, shift_prev: torch.Tensor | None = None) -> torch.Tensor:
    xs = _token_shift(x, shift_prev)
    return rwkv6_channel_mix_step(x, xs, p)


def rwkv6_init_cache(batch: int, d_model: int, n_heads: int, head_dim: int, *, dtype=torch.float32, device=None):
    """Per-layer recurrent state: token-shift slots for both mixes + WKV,
    in f32 (``dtype``: f64 for an f64 model)."""
    return {
        "shift_t": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "shift_c": torch.zeros((batch, d_model), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, n_heads, head_dim, head_dim), dtype=dtype, device=device),
    }


def rwkv6_time_mix_step(
    xt: torch.Tensor,  # (B, D): normalized layer input at this position
    shift_prev: torch.Tensor,  # (B, D)
    wkv: torch.Tensor,  # (B, H, hd, hd)
    p,
    *,
    n_heads: int,
    head_dim: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token time mix; returns (y (B,D), new wkv state)."""
    B, D = xt.shape
    H, hd = n_heads, head_dim
    acc = acc_dtype(xt.dtype)
    xs = shift_prev.to(xt.dtype)
    m = _mix_inputs(xt, xs, p)
    r = reshape_heads(m["r"] @ p["w_r"], (B, H, hd)).to(acc)
    k = reshape_heads(m["k"] @ p["w_k"], (B, H, hd)).to(acc)
    v = reshape_heads(m["v"] @ p["w_v"], (B, H, hd)).to(acc)
    g = F.silu(m["g"] @ p["w_g"])
    w = torch.exp(reshape_heads(_decay(m["w"], p), (B, H, hd)))
    u = p["u"].to(acc)

    kv = k[..., :, None] * v[..., None, :]
    y = (r[..., None, :] @ (wkv + u[None, :, :, None] * kv))[..., 0, :]
    wkv_new = wkv * w[..., None] + kv

    y = _group_norm(y, p, H, hd)
    y = y.reshape(B, D).to(xt.dtype) * g.to(xt.dtype)
    return y @ p["w_o"], wkv_new


def rwkv6_channel_mix_step(xt: torch.Tensor, shift_prev: torch.Tensor, p) -> torch.Tensor:
    """Channel mix of ``xt`` against the previous token ``shift_prev`` (any
    shape with ``xt``'s; the full-sequence form passes the shifted input)."""
    xs = shift_prev.to(xt.dtype)
    xk = xt + p["mu_ck"].to(xt.dtype) * (xs - xt)
    xr = xt + p["mu_cr"].to(xt.dtype) * (xs - xt)
    k = torch.square(F.relu(xk @ p["w_ck"]))
    return torch.sigmoid(xr @ p["w_cr"]) * (k @ p["w_cv"])
