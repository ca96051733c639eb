"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
never falls back from the card to the CPU unasked, keeps its copied modules
equal to their originals, and its CUDA lattice tables equal the lattice."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
from repro_torch.lbm.lattice import D3Q19, D3Q27

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
ORIGINAL = REPO / "src" / "repro"

# modules copied whole from the JAX package (only import lines may differ)
COPIED = [
    "telemetry/__init__.py",
    "telemetry/tracer.py",
    "telemetry/metrics.py",
    "telemetry/export.py",
    "core/__init__.py",
    "core/blockid.py",
    "core/comm.py",
    "core/forest.py",
    "core/refine.py",
    "core/proxy.py",
    "core/migration.py",
    "core/pipeline.py",
    "core/balancing/__init__.py",
    "core/balancing/base.py",
    "core/balancing/sfc.py",
    "core/balancing/diffusion.py",
    "lbm/__init__.py",
    "lbm/lattice.py",
    "lbm/grid.py",
    "lbm/criteria.py",
    "lbm/halo.py",
]

SMALL = dict(root_grid=(1, 1, 1), cells_per_block=(4, 4, 4), max_level=1, nranks=1)


def test_import_leaves_jax_and_repro_unloaded():
    code = (
        "import sys, repro_torch.lbm.driver, repro_torch.state; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_no_jax_or_repro_import_anywhere_in_the_port():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_its_original(rel):
    def body(p: Path) -> list[str]:
        return [
            line
            for line in p.read_text().splitlines()
            if not line.lstrip().startswith(("from ", "import "))
        ]

    assert body(PORT / rel) == body(ORIGINAL / rel), f"{rel} drifted from src/repro/{rel}"


def test_default_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AMRLBM(LidDrivenCavityConfig(**SMALL))


@pytest.mark.parametrize(
    "over, item",
    [
        (dict(stepping_mode="sharded"), "Queue 1.7"),
        (dict(stepping_mode="fused_sharded"), "Queue 1.7"),
        (dict(stepping_mode="device_sharded"), "Queue 1.9"),
        (dict(particles=object()), "Queue 1.6"),
    ],
    ids=["sharded", "fused_sharded", "device_sharded", "particles"],
)
def test_unported_features_name_their_roadmap_item(over, item):
    with pytest.raises(NotImplementedError, match=item):
        AMRLBM(LidDrivenCavityConfig(device="cpu", **SMALL, **over))


def test_unknown_backend_is_refused():
    with pytest.raises(ValueError, match="kernel_backend"):
        AMRLBM(LidDrivenCavityConfig(device="cpu", kernel_backend="pallas", **SMALL))


def _cu_table(src: str, name: str) -> list[str]:
    m = re.search(rf"{name}\[\d+\] = \{{([^}}]*)\}}", src)
    assert m, name
    return [t.strip() for t in m.group(1).split(",") if t.strip()]


def test_cuda_lattice_tables_match_the_lattice():
    src = (PORT / "kernels" / "lbm_collide" / "csrc" / "lbm_collide.cu").read_text()
    for axis, name in enumerate(("c_cx", "c_cy", "c_cz")):
        assert [int(v) for v in _cu_table(src, name)] == D3Q27.c[:, axis].tolist()
    opp = [int(v) for v in _cu_table(src, "c_opp")]
    assert opp == D3Q27.opposite.tolist()
    assert opp[:19] == D3Q19.opposite.tolist()
    np.testing.assert_array_equal(D3Q19.c, D3Q27.c[:19])
    # the TRT loop pairs q with q + 1 for odd q
    assert all(opp[q] == (q + 1 if q % 2 else q - 1) for q in range(1, 27))
    for name, lat in (("c_w19", D3Q19), ("c_w27", D3Q27)):
        w = [float(a) / float(b) for a, b in (t.split("/") for t in _cu_table(src, name))]
        assert w == lat.w.tolist(), name
