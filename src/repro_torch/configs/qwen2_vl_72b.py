"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064. M-RoPE, dynamic resolution; transformer BACKBONE only — the
vision frontend is a stub providing precomputed patch embeddings.
[arXiv:2409.12191; hf]"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="qwen2-vl-72b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv=8,
        d_ff=29568,
        vocab=152064,
        qkv_bias=True,
        m_rope=True,
        m_rope_sections=(16, 24, 24),
        rope_theta=1_000_000.0,
        frontend="vision-stub",
        source="arXiv:2409.12191",
    )
)
