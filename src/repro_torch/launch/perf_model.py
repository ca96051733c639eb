"""Analytic FLOP / HBM-byte models per (architecture x shape).

These are the MODEL_FLOPS = 6·N·D-style quantities of the roofline mandate
(exact formulas, independent of compilation), used (a) as the numerator of
the useful-compute ratio against the loop-corrected HLO dot FLOPs and (b)
as the HBM-traffic estimate, since ``cost_analysis`` bytes are undercounted
inside while loops just like FLOPs.

Conventions (per optimizer/serve step, whole cluster):
  train:  3 x forward FLOPs (fwd + 2x bwd) on 6·N_active·tokens accounting
          plus attention 12·B·S²·H·hd·L/2 (causal) — remat recompute is NOT
          counted here (it is *waste*, visible as useful_ratio < 1).
  decode: 2·N_active per token + attention 4·B·T·H·hd per layer.

HBM bytes (steady state, per step):
  train:  params bf16 read (fwd+bwd+remat fwd) + grad fp32 + AdamW state
          read/write (3 fp32 tensors r+w) + activation stash r/w.
  decode: params read once + KV/state cache read + cache write.
"""

from __future__ import annotations

from ..configs.base import ArchConfig
from ..configs.shapes import ShapeConfig

__all__ = ["model_flops", "hbm_bytes_estimate"]


def _attn_flops_per_layer(cfg: ArchConfig, B: int, S: int, causal: bool) -> float:
    # qk^T + pv : 2 * 2 * B * S * S_kv * H * hd (halved if causal)
    S_kv = min(S, cfg.sliding_window) if cfg.sliding_window else S
    f = 4.0 * B * S * S_kv * cfg.n_heads * cfg.hd
    return f / 2 if causal and not cfg.sliding_window else f


def _n_attn_layers(cfg: ArchConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // max(1, cfg.hybrid_attn_every)  # shared-attn sites
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    B = shape.global_batch
    N_active = cfg.active_params_count()
    if shape.kind in ("train", "prefill"):
        S = shape.seq_len
        tokens = B * S
        f = 2.0 * N_active * tokens
        f += _n_attn_layers(cfg) * _attn_flops_per_layer(cfg, B, S, causal=True)
        if cfg.family in ("ssm", "hybrid"):
            # recurrent-state math: ~ T * H * hd * (hd or N) per layer
            if cfg.family == "ssm":
                H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
                f += 4.0 * tokens * H * hd * hd * cfg.n_layers
            else:
                d_inner = cfg.ssm_expand * cfg.d_model
                f += 6.0 * tokens * d_inner * cfg.ssm_state * cfg.n_layers
        if cfg.is_encoder_decoder:
            enc_tokens = B * cfg.encoder_len
            per_layer = 12 * cfg.d_model**2 if cfg.activation != "swiglu" else 16 * cfg.d_model**2
            f += 2.0 * enc_tokens * cfg.encoder_layers * per_layer
            f += B * S * cfg.encoder_len * cfg.n_heads * cfg.hd * 4 * cfg.n_layers  # cross
        return f * (3.0 if shape.kind == "train" else 1.0)

    # decode: one token per sequence against a cache of seq_len
    T = shape.seq_len
    f = 2.0 * N_active * B
    if cfg.sliding_window:
        T = min(T, cfg.sliding_window)
    f += _n_attn_layers(cfg) * 4.0 * B * T * cfg.n_heads * cfg.hd
    if cfg.family == "ssm":
        H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        f += 4.0 * B * H * hd * hd * cfg.n_layers
    if cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * cfg.d_model
        f += 6.0 * B * d_inner * cfg.ssm_state * cfg.n_layers
    return f


def _cache_bytes(cfg: ArchConfig, shape: ShapeConfig, dtype_bytes: int = 2) -> float:
    B, T = shape.global_batch, shape.seq_len
    if cfg.sliding_window:
        T = min(T, cfg.sliding_window)
    kv = 2.0 * _n_attn_layers(cfg) * B * T * cfg.n_kv * cfg.hd * dtype_bytes
    state = 0.0
    if cfg.family == "ssm":
        H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        state = 4.0 * B * H * hd * hd * cfg.n_layers  # fp32 wkv
    if cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * cfg.d_model
        H = d_inner // cfg.ssm_head_dim
        state = 4.0 * B * H * cfg.ssm_state * cfg.ssm_head_dim * cfg.n_layers
    if cfg.is_encoder_decoder:
        kv += 2.0 * cfg.n_layers * B * cfg.encoder_len * cfg.n_kv * cfg.hd * dtype_bytes
    return kv + state


def hbm_bytes_estimate(cfg: ArchConfig, shape: ShapeConfig) -> float:
    P = cfg.params_count()
    if shape.kind == "train":
        B, S = shape.global_batch, shape.seq_len
        act = 2.0 * B * S * cfg.d_model * (2 * cfg.n_layers)  # bf16 stash r+w
        # bf16 params read 3x (fwd, bwd, remat-fwd), fp32 grads w+r,
        # AdamW master/m/v read+write in fp32
        return 3 * 2 * P + 2 * 4 * P + 6 * 4 * P + 2 * act
    if shape.kind == "prefill":
        B, S = shape.global_batch, shape.seq_len
        act = 2.0 * B * S * cfg.d_model * (2 * cfg.n_layers)
        return 2 * P + act
    # decode: read active params once, read whole cache, write one slot
    P_act = cfg.active_params_count()
    cache = _cache_bytes(cfg, shape)
    return 2 * P_act * 1.0 + cache + cache / max(1, shape.seq_len)
