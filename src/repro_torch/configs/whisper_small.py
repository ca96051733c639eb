"""whisper-small [audio]: 12L d_model=768 12H d_ff=3072 vocab=51865.
Encoder-decoder; conv frontend is a STUB (precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="whisper-small",
        family="audio",
        n_layers=12,  # decoder layers
        d_model=768,
        n_heads=12,
        n_kv=12,
        d_ff=3072,
        vocab=51865,
        norm="layernorm",
        activation="gelu",
        encoder_layers=12,
        encoder_len=1500,
        frontend="audio-stub",
        source="arXiv:2212.04356",
    )
)
