"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
GQA with QKV bias. [arXiv:2407.10671; hf]"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="qwen2-0.5b",
        family="dense",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv=2,
        d_ff=4864,
        vocab=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        source="arXiv:2407.10671",
    )
)
