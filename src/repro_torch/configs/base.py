"""Architecture configuration dataclass + registry for the assigned archs."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace

__all__ = ["ArchConfig", "register", "get_config", "all_arch_ids"]


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int | None = None  # default d_model // n_heads
    # options
    qkv_bias: bool = False
    nonparametric_ln: bool = False  # olmo: LN without scale/bias
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "swiglu"  # swiglu | gelu
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # attention windowing (mixtral SWA)
    sliding_window: int | None = None
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # ssm / hybrid (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    hybrid_attn_every: int = 0  # zamba2: shared attn block every k mamba layers
    # rwkv
    rwkv_head_dim: int = 64
    # vlm / audio frontend stubs
    m_rope: bool = False
    m_rope_sections: tuple[int, int, int] = (16, 24, 24)
    frontend: str | None = None  # "vision-stub" | "audio-stub"
    encoder_layers: int = 0  # whisper encoder depth
    encoder_len: int = 1500  # precomputed frame embeddings (stub)
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / windowed attention)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def is_encoder_decoder(self) -> bool:
        return self.family == "audio"

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return replace(
            self,
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv=min(4, max(1, self.n_kv if self.n_kv < self.n_heads else 4)),
            d_ff=128,
            vocab=256,
            head_dim=16,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state or self.family == "ssm" else self.ssm_head_dim,
            rwkv_head_dim=16,
            sliding_window=64 if self.sliding_window else None,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_len=16 if self.encoder_layers else self.encoder_len,
            m_rope_sections=(2, 3, 3) if self.m_rope else self.m_rope_sections,
        )

    def params_count(self) -> int:
        """Approximate total parameter count (used for 6ND roofline math)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.hd
        emb = V * D * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":  # rwkv6
            att = 5 * D * D + 2 * D * 64  # r,k,v,g,o + decay lora
            mlp = 3 * D * F // 2 if self.activation == "swiglu" else 2 * D * F
            return emb + L * (att + mlp)
        d_inner = self.ssm_expand * D
        mamba = (
            D * (2 * d_inner + 2 * self.ssm_state + d_inner // self.ssm_head_dim)
            + d_inner * D
        )
        attn = D * (self.n_heads * hd) + 2 * D * (self.n_kv * hd) + (self.n_heads * hd) * D
        if self.activation == "swiglu":
            mlp = 3 * D * F
        else:
            mlp = 2 * D * F
        if self.n_experts:
            moe = D * self.n_experts + self.n_experts * mlp
            layer = attn + moe
        elif self.family in ("hybrid",):
            # mamba layers + shared attn applications approximated
            layer = mamba + (attn + mlp) / max(1, self.n_layers / max(1, self.n_layers // max(1, self.hybrid_attn_every)))
        else:
            layer = attn + mlp
        enc = self.encoder_layers * (attn + mlp + (attn if self.is_encoder_decoder else 0))
        return int(emb + L * layer + enc)

    def active_params_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.n_experts:
            return self.params_count()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        hd = self.hd
        emb = self.vocab * D * 2
        attn = D * (self.n_heads * hd) + 2 * D * (self.n_kv * hd) + (self.n_heads * hd) * D
        mlp_one = 3 * D * F
        layer = attn + D * self.n_experts + self.top_k * mlp_one
        return int(emb + L * layer)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_config(arch_id: str) -> ArchConfig:
    if not _REGISTRY:
        from . import _load_all  # lazy import of all config modules

        _load_all()
    return _REGISTRY[arch_id]


def all_arch_ids() -> list[str]:
    if not _REGISTRY:
        from . import _load_all

        _load_all()
    return sorted(_REGISTRY)
