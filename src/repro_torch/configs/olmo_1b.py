"""olmo-1b [dense]: 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.
Non-parametric LayerNorm (no scale/bias). [arXiv:2402.00838; hf]"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="olmo-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv=16,
        d_ff=8192,
        vocab=50304,
        nonparametric_ln=True,
        norm="layernorm",
        activation="swiglu",
        tie_embeddings=True,
        source="arXiv:2402.00838",
    )
)
