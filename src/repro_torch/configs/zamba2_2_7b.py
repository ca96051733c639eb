"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64. Mamba2 backbone + shared attention blocks. [arXiv:2411.15242; hf]"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv=32,
        d_ff=10240,
        vocab=32000,
        head_dim=80,
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        hybrid_attn_every=6,  # one shared attn block application per 6 mamba layers
        source="arXiv:2411.15242",
    )
)
