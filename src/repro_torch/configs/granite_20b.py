"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
Llama-architecture, code model. [arXiv:2405.04324; hf]"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="granite-20b",
        family="dense",
        n_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv=1,
        d_ff=24576,
        vocab=49152,
        activation="gelu",
        norm="layernorm",
        source="arXiv:2405.04324",
    )
)
