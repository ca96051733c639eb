"""Model zoo for every family of the configs: dense, vlm, moe, ssm (rwkv6),
hybrid (mamba2 + shared attention) and audio (whisper), on PyTorch, one
module a layer."""

from .zoo import Model, build_model

__all__ = ["build_model", "Model"]
