"""Mamba2 block in the chunked SSD (state-space duality) form, on torch.

The PyTorch twin of the JAX package's ``models/mamba2.py``. The sequence is
processed in chunks of 128 (padded to a whole number of chunks) with the
block decomposition of the SSD paper: within a chunk, (L x L) products
masked by the causal pairwise decay; across chunks, a short scan that
carries the (H, N, P) state and emits, for each chunk, the state it starts
from. The per-head scalar decay keeps every pairwise decay exponent <= 0.
The state math runs in f32 (f64 for an f64 model) whatever the model dtype.

Decode carries the conv cache (the last K-1 inputs) and the SSM state,
O(1) a token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import acc_dtype, reshape_heads

__all__ = ["mamba2_forward", "mamba2_decode_step", "mamba2_init_cache"]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``logaddexp(x, 0)``, the reference's form (no
    linear cut-over above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Pairwise segment sums: out[..., i, j] = sum_{k in (j, i]} a[..., k]
    for j <= i, -inf elsewhere (the log-decay matrix of the SSD paper)."""
    L = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, n_state: int, n_heads: int):
    return torch.split(zxbcdt, [d_inner, d_inner, n_state, n_state, n_heads], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence axis. xbc: (B,S,Cd), w: (K,Cd)."""
    K, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = torch.zeros_like(xbc)
    for k in range(K):  # K = 4: unrolled taps, in the reference's order
        out = out + pad[:, k : k + S] * w[k]
    return out + b


def _gated_norm_out(y: torch.Tensor, z: torch.Tensor, p, dtype: torch.dtype) -> torch.Tensor:
    """Gated RMSNorm (eps 1e-5) then the output projection."""
    acc = acc_dtype(dtype)
    gated = y * F.silu(z)
    var = gated.to(acc).square().mean(dim=-1, keepdim=True)
    gated = (gated.to(acc) * torch.rsqrt(var + 1e-5)).to(dtype)
    return (gated * p["norm_scale"]) @ p["out_proj"]


def mamba2_forward(
    u: torch.Tensor,  # (B, S, D)
    p,
    *,
    d_state: int,
    head_dim: int,
    chunk: int = 128,
    wsc=None,
) -> torch.Tensor:
    Bsz, S, D = u.shape
    d_inner = p["out_proj"].shape[0]
    H = d_inner // head_dim
    N = d_state
    acc = acc_dtype(u.dtype)
    wsc = wsc or (lambda a, dims: a)

    z, x, Bm, Cm, dt = _split_proj(u @ p["in_proj"], d_inner, N, H)
    xbc = F.silu(_causal_conv(torch.cat([x, Bm, Cm], dim=-1), p["conv_w"], p["conv_b"]))
    x, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    Bm, Cm = wsc(Bm, "b.."), wsc(Cm, "b..")

    dt = wsc(_softplus(dt.to(acc) + p["dt_bias"].to(acc)), "b.m")  # (B,S,H)
    A = -torch.exp(p["A_log"].to(acc))  # (H,)
    xh = wsc(reshape_heads(x, (Bsz, S, H, head_dim)), "b.m.")

    L = min(chunk, S)
    pad = -S % L
    xp, Bp, Cp, dtp = xh, Bm, Cm, dt
    if pad:
        xp = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bp, Cp, dtp = (F.pad(a, (0, 0, 0, pad)) for a in (Bm, Cm, dt))
    nc = (S + pad) // L
    xc = xp.reshape(Bsz, nc, L, H, head_dim).to(acc)
    Bc = Bp.reshape(Bsz, nc, L, N).to(acc)
    Cc = Cp.reshape(Bsz, nc, L, N).to(acc)
    dtc = dtp.reshape(Bsz, nc, L, H)
    dA = dtc * A  # (B,nc,L,H) log decays (<= 0)

    # intra-chunk: Y_intra = (C B^T o decay o causal) @ (dt x)
    Lmat = torch.exp(_segsum(dA.transpose(2, 3)))  # (B,nc,H,L,L)
    Gm = Cc @ Bc.transpose(-1, -2)  # (B,nc,L,L)
    xdt = xc * dtc[..., None]  # (B,nc,L,H,P)
    y_intra = ((Gm[:, :, None] * Lmat) @ xdt.transpose(2, 3)).transpose(2, 3)  # (B,nc,L,H,P)

    # chunk state contributions and the inter-chunk scan
    a_cum = torch.cumsum(dA, dim=2)  # (B,nc,L,H)
    a_end = a_cum[:, :, -1:]  # (B,nc,1,H)
    decay_to_end = torch.exp(a_end - a_cum)  # <= 1
    S_chunk = Bc.transpose(-1, -2)[:, :, None] @ (decay_to_end[..., None] * xdt).transpose(2, 3)  # (B,nc,H,N,P)
    chunk_decay = torch.exp(a_end[:, :, 0])  # (B,nc,H)
    h = torch.zeros((Bsz, H, N, head_dim), dtype=acc, device=u.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)  # the state this chunk starts from
        h = h * chunk_decay[:, c, :, None, None] + S_chunk[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # (B,nc,H,N,P)
    decay_from_start = torch.exp(a_cum)  # (B,nc,L,H)
    y_inter = (Cc[:, :, None] @ h_prev) * decay_from_start.transpose(2, 3)[..., None]  # (B,nc,H,L,P)
    y_inter = y_inter.transpose(2, 3)

    y = (y_intra + y_inter).reshape(Bsz, S + pad, H, head_dim)[:, :S]
    y = y + xh * p["D_skip"].to(acc)[None, None, :, None]
    y = wsc(y.reshape(Bsz, S, d_inner), "b.m").to(u.dtype)
    return _gated_norm_out(y, z, p, u.dtype)


def mamba2_init_cache(batch: int, p, *, d_state: int, head_dim: int, conv_k: int, dtype=torch.float32):
    """Conv history (K-1 inputs) and SSM state, in f32 (``dtype``: f64 for
    an f64 model)."""
    d_inner = p["out_proj"].shape[0]
    H = d_inner // head_dim
    dev = p["out_proj"].device
    return {
        "conv": torch.zeros((batch, conv_k - 1, d_inner + 2 * d_state), dtype=dtype, device=dev),
        "ssm": torch.zeros((batch, H, d_state, head_dim), dtype=dtype, device=dev),
    }


def mamba2_decode_step(
    u: torch.Tensor,  # (B, 1, D)
    cache: dict,
    p,
    *,
    d_state: int,
    head_dim: int,
) -> tuple[torch.Tensor, dict]:
    """One token; returns (out (B,1,D), {"conv", "ssm"}: the new state)."""
    Bsz, _, D = u.shape
    d_inner = p["out_proj"].shape[0]
    H = d_inner // head_dim
    N = d_state
    acc = acc_dtype(u.dtype)

    z, x, Bm, Cm, dt = _split_proj(u[:, 0] @ p["in_proj"], d_inner, N, H)
    xbc = torch.cat([x, Bm, Cm], dim=-1)  # (B, conv_dim)
    hist = torch.cat([cache["conv"].to(acc), xbc[:, None].to(acc)], dim=1)  # (B,K,Cd)
    xbc = F.silu((hist * p["conv_w"].to(acc)).sum(dim=1) + p["conv_b"].to(acc))
    x, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)

    dt = _softplus(dt.to(acc) + p["dt_bias"].to(acc))  # (B,H)
    A = -torch.exp(p["A_log"].to(acc))
    xh = reshape_heads(x, (Bsz, H, head_dim))
    dA = torch.exp(dt * A)  # (B,H)
    dBx = Bm[:, None, :, None] * (dt[..., None] * xh)[:, :, None, :]  # (B,H,N,P)
    ssm = cache["ssm"] * dA[..., None, None] + dBx
    y = (Cm[:, None, None, :] @ ssm)[..., 0, :]  # (B,H,P)
    y = y + xh * p["D_skip"].to(acc)[None, :, None]
    y = y.reshape(Bsz, d_inner).to(u.dtype)
    out = _gated_norm_out(y, z, p, u.dtype)[:, None]
    return out, {"conv": hist[:, 1:], "ssm": ssm}
