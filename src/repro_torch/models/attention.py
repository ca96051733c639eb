"""Attention: chunked (flash-style) prefill path and ring-buffer KV-cache
decode, with sliding windows and GQA.

The PyTorch twin of the JAX package's ``models/attention.py``. The chunked
path never materializes the full (S x S) score matrix: it loops over KV
chunks with an online-softmax accumulator inside a loop over Q chunks, so
peak memory is O(S * chunk), as in the reference. The distributed
flash-decode (``sharded_decode_attention``) combines each rank's slice of
the cache with all-reduces over a process group.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from .layers import acc_dtype

__all__ = ["chunked_attention", "decode_attention", "sharded_decode_attention"]

_NEG = -1e30


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, T, Hkv, d) -> (B, T, Hkv*groups, d) for GQA."""
    if groups == 1:
        return k
    b, t, h, d = k.shape
    return k[:, :, :, None, :].expand(b, t, h, groups, d).reshape(b, t, h * groups, d)


def chunked_attention(
    q: torch.Tensor,  # (B, S, H, d)
    k: torch.Tensor,  # (B, T, Hkv, d)
    v: torch.Tensor,  # (B, T, Hkv, d)
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Flash-style attention with online softmax over KV chunks, in f32
    (f64 for f64 inputs)."""
    B, S, H, d = q.shape
    _, T, Hkv, _ = k.shape
    groups = H // Hkv
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    scale = 1.0 / np.sqrt(d)

    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    # pad to multiples
    S_pad = -S % q_chunk
    T_pad = -T % kv_chunk
    # padded only where a chunk does not divide the length (torch 2.11's
    # DTensor pad gives its result one placement on a 2-D mesh)
    qp = F.pad(q, (0, 0, 0, 0, 0, S_pad)) if S_pad else q
    kp = F.pad(k, (0, 0, 0, 0, 0, T_pad)) if T_pad else k
    vp = F.pad(v, (0, 0, 0, 0, 0, T_pad)) if T_pad else v
    nq, nkv = (S + S_pad) // q_chunk, (T + T_pad) // kv_chunk

    dev = q.device
    q_pos_base = torch.arange(q_chunk, device=dev) + q_offset
    kv_pos_base = torch.arange(kv_chunk, device=dev)

    acc = acc_dtype(q.dtype)
    qp = qp.to(acc).reshape(B, nq, q_chunk, H, d).permute(1, 0, 3, 2, 4)  # (nq,B,H,qc,d)
    kp = kp.to(acc).reshape(B, nkv, kv_chunk, H, d).permute(1, 0, 3, 2, 4)
    vp = vp.to(acc).reshape(B, nkv, kv_chunk, H, d).permute(1, 0, 3, 2, 4)

    outs = []
    for qi in range(nq):
        q_blk = qp[qi]
        q_pos = q_pos_base + qi * q_chunk
        m = torch.full((B, H, q_chunk), _NEG, dtype=acc, device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=acc, device=dev)
        o = torch.zeros((B, H, q_chunk, d), dtype=acc, device=dev)
        for kj in range(nkv):
            k_blk, v_blk = kp[kj], vp[kj]
            kv_pos = kv_pos_base + kj * kv_chunk
            s = (q_blk @ k_blk.transpose(-1, -2)) * scale
            mask = kv_pos[None, :] < T  # drop padded kv
            if causal:
                mask = mask & (kv_pos[None, :] <= q_pos[:, None])
            if window is not None:
                mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(mask[None, None], s, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + p @ v_blk
            m = m_new
        outs.append(o / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, S + S_pad, H, d)[:, :S]
    return out.to(q.dtype)


def _heads_major(cache: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """A (B, T, Hkv, d) cache as a contiguous (B, Hkv, T, d) tensor in
    ``acc``, in one copy. A DTensor takes two: its one-step copy with a
    memory format gives a transposed shard the wrong tensor dimension."""
    if isinstance(cache, DTensor):
        return cache.transpose(1, 2).to(acc).contiguous()
    return cache.transpose(1, 2).to(acc, memory_format=torch.contiguous_format)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, d)
    k_cache: torch.Tensor,  # (B, T, Hkv, d)
    v_cache: torch.Tensor,
    *,
    window: int | None = None,
    fill: torch.Tensor | int | None = None,
    slot: torch.Tensor | int | None = None,
) -> torch.Tensor:
    """Single-token decode against a ring-buffer KV cache.

    ``slot`` is the index the newest entry was just written to; entry ages
    are ``(slot - idx) mod T`` (a floor modulo: torch's ``%``, never
    ``fmod``). A roll-by-one layout (newest = last) is the ``slot = T-1``
    special case. ``fill`` masks warm-up slots (age >= fill); ``window``
    masks beyond the sliding window.

    Grouped-query contraction without repeating the cache: q is reshaped to
    (B, Hkv, G, d) and contracted against the cache's Hkv heads. The
    reference accumulates both products in f32 over the cache in its storage
    dtype; here q, the cache and the probabilities (rounded to the cache's
    dtype first, as the reference rounds them) are upcast to f32 before the
    products, which computes the same sums and, for a bf16 cache, reads it
    once and writes and reads an f32 copy."""
    B, _, H, d = q.shape
    _, T, Hkv, _ = k_cache.shape
    groups = H // Hkv
    scale = 1.0 / np.sqrt(d)
    acc = acc_dtype(q.dtype)
    qg = q.reshape(B, Hkv, groups, d).to(acc)
    kt = _heads_major(k_cache, acc)  # (B,Hkv,T,d)
    s = (qg @ kt.transpose(-1, -2)) * scale  # (B, Hkv, G, T)
    idx = torch.arange(T, device=q.device)
    age = (slot - idx) % T if slot is not None else T - 1 - idx
    if window is not None:
        s = torch.where(age < window, s, _NEG)
    if fill is not None:
        s = torch.where(age < fill, s, _NEG)
    p = torch.softmax(s, dim=-1)
    vt = _heads_major(v_cache, acc)
    out = p.to(v_cache.dtype).to(acc) @ vt  # (B, Hkv, G, d)
    return out.reshape(B, 1, H, d).to(q.dtype)


def sharded_decode_attention(
    q: torch.Tensor,  # (B, 1, H, d): the same on every rank of ``group``
    k_cache: torch.Tensor,  # (B, T_local, Hkv, d): this rank's slice of T
    v_cache: torch.Tensor,
    *,
    group: dist.ProcessGroup | None = None,
) -> torch.Tensor:
    """Distributed flash-decode: every rank attends to its local KV slice;
    the partial (max, sum, weighted-value) statistics are combined across
    ``group`` (the reference's ``axis_name``; None is the default group)
    with an all-reduce MAX of the row maxima and all-reduce SUMs of the sums
    and the weighted values. In f32 (f64 for f64 inputs), with no window,
    warm-up or ring-buffer masking, as the reference's."""
    B, _, H, d = q.shape
    _, T_local, Hkv, _ = k_cache.shape
    groups = H // Hkv
    scale = 1.0 / np.sqrt(d)
    acc = acc_dtype(q.dtype)
    qg = q.reshape(B, H, d).to(acc)
    kg = _repeat_kv(k_cache, groups).to(acc)
    vg = _repeat_kv(v_cache, groups).to(acc)
    s = torch.einsum("bhd,bthd->bht", qg, kg) * scale  # (B, H, T_local)
    m = s.amax(dim=-1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bht,bthd->bhd", p, vg)
    dist.all_reduce(l, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(o, op=dist.ReduceOp.SUM, group=group)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out[:, None].to(q.dtype)
