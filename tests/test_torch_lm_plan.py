"""``chip_smoke.py``'s phase 3c plan fits one H100 80GB, checked on the meta
device here.

Phase 3c serves five architectures at full width on one card, each at the
depths and decode batch of its ``LM_ARCHS`` entry, and decodes the
``long_500k`` cells of ``LM_LONG``. Built on the meta device at those depths
(no memory is allocated), each entry's bf16 weights plus
``repro_torch.launch.perf_model``'s decode cache bytes at its batch and cache
length must stay under 64 GB, and its f32 leg's weights under 56 GB; each
long cell's bf16 weights plus its ``long_500k`` cache under 64 GB. The card
holds 79.18 GiB (85.0 GB), so what is left covers the decode's f32 copies of
one layer's cache and the prefill's activations. A plan that would not fit
fails here, not after card time.
"""

import importlib.util
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.shapes import ShapeConfig, cells_for
from repro_torch.launch.perf_model import _cache_bytes
from repro_torch.models import build_model

REPO = Path(__file__).resolve().parents[1]
BF16_PLUS_CACHE_GB = 64.0
F32_LEG_GB = 56.0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_plan", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()


def _weight_gb(cfg, dtype) -> float:
    model = build_model(cfg, device="meta", dtype=dtype)
    return sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9


@pytest.mark.parametrize("arch", list(CS.LM_ARCHS))
def test_phase_3c_arch_fits_one_card(arch):
    spec = CS.LM_ARCHS[arch]
    full = get_config(arch)
    assert 0 < spec["cut"] <= spec["layers"] <= full.n_layers and spec["bf16_layers"] <= full.n_layers
    bf16 = replace(full, n_layers=spec["bf16_layers"])
    cache = _cache_bytes(bf16, ShapeConfig("decode", spec["decode_T"], spec["decode_B"], "decode")) / 1e9
    weights = _weight_gb(bf16, torch.bfloat16)
    assert weights + cache < BF16_PLUS_CACHE_GB, (arch, weights, cache)
    f32 = _weight_gb(replace(full, n_layers=spec["layers"]), torch.float32)
    assert f32 < F32_LEG_GB, (arch, f32)
    # the witness holds its f32 and f64 weights on the card at once
    cut = replace(full, n_layers=spec["cut"])
    assert _weight_gb(cut, torch.float32) + _weight_gb(cut, torch.float64) < F32_LEG_GB, arch


@pytest.mark.parametrize("arch", list(CS.LM_LONG))
def test_phase_3c_long_500k_cell_fits_one_card(arch):
    spec = CS.LM_LONG[arch]
    full = get_config(arch)
    assert SHAPES["long_500k"] in cells_for(full)
    cfg = replace(full, n_layers=spec["layers"]) if spec["layers"] else full
    cache = _cache_bytes(cfg, SHAPES["long_500k"]) / 1e9
    weights = _weight_gb(cfg, torch.bfloat16)
    assert weights + cache < BF16_PLUS_CACHE_GB, (arch, weights, cache)
