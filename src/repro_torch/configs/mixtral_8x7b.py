"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8 experts top-2, sliding-window attention. [arXiv:2401.04088; hf]"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv=8,
        d_ff=14336,
        vocab=32000,
        n_experts=8,
        top_k=2,
        sliding_window=4096,
        source="arXiv:2401.04088",
    )
)
