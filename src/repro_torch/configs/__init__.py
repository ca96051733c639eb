"""Architecture configs: one module per assigned architecture (+ the paper's
own AMR/LBM benchmark config in :mod:`repro.configs.amr_lbm`)."""

from .base import ArchConfig, all_arch_ids, get_config
from .shapes import SHAPES, ShapeConfig, cells_for

_ARCH_MODULES = [
    "olmo_1b",
    "qwen2_0_5b",
    "yi_9b",
    "granite_20b",
    "zamba2_2_7b",
    "granite_moe_1b_a400m",
    "mixtral_8x7b",
    "rwkv6_3b",
    "qwen2_vl_72b",
    "whisper_small",
]


def _load_all() -> None:
    import importlib

    for m in _ARCH_MODULES:
        importlib.import_module(f"{__name__}.{m}")


_load_all()

__all__ = [
    "ArchConfig",
    "ShapeConfig",
    "SHAPES",
    "cells_for",
    "get_config",
    "all_arch_ids",
]
