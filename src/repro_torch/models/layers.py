"""Shared layer primitives: norms, RoPE / M-RoPE, MLPs, embeddings.

The PyTorch twin of the JAX package's ``models/layers.py``: the same
functions on tensors, computing in the reference's precisions and casting
in its order (norms in f32, then to ``x.dtype``, then times the scale in
``x.dtype``; rotary angles in f32; the tanh form of GELU).

Where the reference computes in f32, the port computes in
``acc_dtype(dtype)``: f32 for bf16 and f32 models, as there, and f64 for a
float64 model, so that a float64 model is float64 throughout and can
witness the f32 model's rounding error.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

__all__ = [
    "acc_dtype",
    "rms_norm",
    "layer_norm",
    "norm",
    "rope_freqs",
    "apply_rope",
    "mrope_freqs",
    "mlp",
    "init_linear",
    "reshape_heads",
]


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the reference's f32 steps take: f32, or f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x: torch.Tensor, scale: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(acc_dtype(x.dtype))
    var = xf.square().mean(dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return y * scale.to(x.dtype) if scale is not None else y


def layer_norm(
    x: torch.Tensor,
    scale: torch.Tensor | None,
    bias: torch.Tensor | None,
    eps: float = 1e-5,
) -> torch.Tensor:
    xf = x.to(acc_dtype(x.dtype))
    mean = xf.mean(dim=-1, keepdim=True)
    # population variance, as jnp.var (torch.var defaults to the unbiased one)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    if scale is not None:
        y = y * scale.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def norm(x: torch.Tensor, params, kind: str) -> torch.Tensor:
    """Dispatch on norm kind; ``params`` may be None (non-parametric, olmo)."""
    if kind == "rmsnorm":
        return rms_norm(x, None if params is None else params.get("scale"))
    return layer_norm(
        x,
        None if params is None else params.get("scale"),
        None if params is None else params.get("bias"),
    )


# -- rotary embeddings --------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _inv_freqs(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The inverse frequencies, computed in float64 as the reference's numpy
    expression and rounded once to f32, as JAX (without x64) rounds them when
    they meet the f32 positions: the angles are then f32 products, as there.
    Cached per device: a host-to-device copy each decode step would make the
    host wait for the card."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    return torch.tensor(inv, dtype=torch.float32, device=device)


def rope_freqs(
    positions: torch.Tensor, head_dim: int, theta: float, dtype: torch.dtype = torch.float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables, shape positions.shape + (head_dim//2,), with the
    angles in ``dtype`` (f32 as the reference; f64 for a float64 model)."""
    inv = _inv_freqs(head_dim, float(theta), positions.device).to(dtype)
    ang = positions[..., None].to(dtype) * inv
    return torch.cos(ang), torch.sin(ang)


def mrope_freqs(
    positions: torch.Tensor,  # (B, 3, S): temporal / height / width position ids
    head_dim: int,
    theta: float,
    sections: tuple[int, int, int],
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE (qwen2-vl): the head_dim/2 frequency slots are split into
    (t, h, w) sections, each driven by its own position stream."""
    assert sum(sections) == head_dim // 2, (sections, head_dim)
    inv = _inv_freqs(head_dim, float(theta), positions.device).to(dtype)
    ang_all = positions[..., None].to(dtype) * inv  # (B,3,S,hd/2)
    parts = []
    start = 0
    for i, sec in enumerate(sections):
        parts.append(ang_all[:, i, :, start : start + sec])
        start += sec
    ang = torch.cat(parts, dim=-1)  # (B, S, hd/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE. x: (B, S, H, hd); cos/sin: (B, S, hd//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)  # (B, S, 1, hd/2)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# -- MLP ------------------------------------------------------------------------


def mlp(x: torch.Tensor, p, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        gate = F.silu(x @ p["w_gate"])
        up = x @ p["w_up"]
        return (gate * up) @ p["w_down"]
    if activation == "gelu":
        h = x @ p["w_up"]
        if p.get("b_up") is not None:
            h = h + p["b_up"]
        # jax.nn.gelu defaults to the tanh approximation; F.gelu to erf
        h = F.gelu(h, approximate="tanh") @ p["w_down"]
        return h + p["b_down"] if p.get("b_down") is not None else h
    if activation == "relu2":
        h = torch.square(F.relu(x @ p["w_up"]))
        return h @ p["w_down"]
    raise ValueError(activation)


def init_linear(
    generator: torch.Generator, shape: tuple[int, ...], dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """A standard normal over sqrt(fan_in), drawn in f32 on the generator's
    device, then cast."""
    fan_in = shape[0] if len(shape) == 2 else shape[-2]
    w = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (w / np.sqrt(fan_in)).to(dtype)


def reshape_heads(y: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``y.reshape(shape)``, where ``shape`` splits ``y``'s last dimension
    into (heads, head_dim). A DTensor whose last dimension is sharded over a
    number of ranks that does not divide the heads (14 heads on a 16-way
    axis) is first gathered on that dimension: DTensor splits an even shard
    only. A plain tensor is reshaped as it is."""
    if isinstance(y, DTensor):
        last, ranks = y.ndim - 1, 1
        for size, pl in zip(y.device_mesh.shape, y.placements):
            if pl.is_shard(last):
                ranks *= size
        if shape[-2] % ranks:
            y = y.redistribute(y.device_mesh, [Replicate() if pl.is_shard(last) else pl for pl in y.placements])
    return y.reshape(shape)
