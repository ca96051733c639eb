"""Assigned input shapes and the realized (arch x shape) cell set.

LM transformer shapes are seq_len x global_batch. ``decode_*`` / ``long_*``
lower ``serve_step`` (one new token against a KV cache/recurrent state of
seq_len), NOT ``train_step``. ``long_500k`` requires sub-quadratic attention:
it runs for SSM/hybrid archs and for windowed-attention archs (mixtral SWA
keeps a rolling window cache); it is skipped for pure full-attention archs
(olmo, qwen2, yi, granite, granite-moe, qwen2-vl, whisper) — see DESIGN.md
§Arch-applicability.
"""

from __future__ import annotations

from dataclasses import dataclass

from .base import ArchConfig

__all__ = ["ShapeConfig", "SHAPES", "cells_for"]


@dataclass(frozen=True)
class ShapeConfig:
    shape_id: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cells_for(cfg: ArchConfig) -> list[ShapeConfig]:
    """The shape cells realized for an architecture (skips annotated)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        out.append(SHAPES["long_500k"])
    return out
