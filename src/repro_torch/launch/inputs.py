"""Meta-device stand-ins for every model input (dry run, no allocation).

The twin of the JAX package's ``launch/inputs.py``: a tensor on the
``meta`` device has a shape, a dtype and strides and no storage, as a
``jax.ShapeDtypeStruct``; building on ``meta`` is ``jax.eval_shape``.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..configs.shapes import ShapeConfig
from ..models.zoo import Model

__all__ = ["input_specs", "cache_specs", "param_shapes"]

META = torch.device("meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig, *, act_dtype=torch.bfloat16) -> dict:
    """Batch stand-ins for train/prefill (token sequences) or decode (1 token)."""
    B = shape.global_batch
    S = 1 if shape.kind == "decode" else shape.seq_len
    batch: dict = {"tokens": torch.empty((B, S), dtype=torch.int32, device=META)}
    if shape.kind == "train":
        batch["labels"] = torch.empty((B, S), dtype=torch.int32, device=META)
    if cfg.m_rope:
        batch["positions"] = torch.empty((B, 3, S), dtype=torch.int32, device=META)
        batch["frontend_embeds"] = torch.empty((B, S, cfg.d_model), dtype=act_dtype, device=META)
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = torch.empty((B, cfg.encoder_len, cfg.d_model), dtype=act_dtype, device=META)
    return batch


def cache_specs(model: Model, shape: ShapeConfig, *, dtype=torch.bfloat16) -> dict:
    """The KV-cache/recurrent-state dict of ``init_cache`` for a decode
    shape, on the meta device (``model`` must live there)."""
    return model.init_cache(shape.global_batch, shape.seq_len, dtype)


def param_shapes(model: Model) -> dict[str, torch.Tensor]:
    """``{name: parameter}`` of a model built on the meta device."""
    return dict(model.named_parameters())
