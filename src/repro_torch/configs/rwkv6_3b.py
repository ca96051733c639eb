"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.
RWKV-6 "Finch": data-dependent decay. [arXiv:2404.05892; hf]"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="rwkv6-3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,  # 2560 / 64 WKV heads
        n_kv=40,
        d_ff=8960,
        vocab=65536,
        rwkv_head_dim=64,
        activation="relu2",  # rwkv channel-mix uses squared ReLU
        source="arXiv:2404.05892",
    )
)
