"""yi-9b [dense]: 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
Llama-architecture GQA. [arXiv:2403.04652; hf]"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="yi-9b",
        family="dense",
        n_layers=48,
        d_model=4096,
        n_heads=32,
        n_kv=4,
        d_ff=11008,
        vocab=64000,
        source="arXiv:2403.04652",
    )
)
