"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
never falls back from the card to the CPU unasked (nor puts a rank on a
device it was not given), keeps its copied modules equal to their
originals, and its CUDA lattice tables equal the lattice."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import Comm
from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
from repro_torch.lbm.engines import DeviceShardedEngine, resolve_rank_devices
from repro_torch.lbm.lattice import D3Q19, D3Q27

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
ORIGINAL = REPO / "src" / "repro"
EXAMPLE = REPO / "examples" / "lbm_cavity_amr_torch.py"

# modules copied whole from the JAX package (only import lines may differ)
COPIED = [
    "telemetry/__init__.py",
    "telemetry/tracer.py",
    "telemetry/metrics.py",
    "telemetry/export.py",
    "core/__init__.py",
    "core/blockid.py",
    "core/checkpoint.py",
    "core/resilience.py",
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
    "particles/storage.py",
    "particles/balance.py",
    "particles/redistribute.py",
    "serving/__init__.py",
    "serving/service.py",
    "serving/elastic.py",
    "analysis/findings.py",
    "analysis/protocol.py",
    "configs/__init__.py",
    "configs/base.py",
    "configs/shapes.py",
    "configs/olmo_1b.py",
    "configs/qwen2_0_5b.py",
    "configs/yi_9b.py",
    "configs/granite_20b.py",
    "configs/zamba2_2_7b.py",
    "configs/granite_moe_1b_a400m.py",
    "configs/mixtral_8x7b.py",
    "configs/rwkv6_3b.py",
    "configs/qwen2_vl_72b.py",
    "configs/whisper_small.py",
    "launch/__init__.py",
    "launch/perf_model.py",
    "sharding/__init__.py",
    "train/data.py",
    "train/moe_balance.py",
    "train/elastic.py",
]
# the port's example twins and its lint driver: each imports only repro_torch
TWINS = [
    "examples/quickstart_torch.py",
    "examples/resilience_demo_torch.py",
    "examples/particles_in_cavity_torch.py",
    "examples/trace_fused_sharded_torch.py",
    "examples/train_lm_torch.py",
    "examples/moe_diffusion_balance_torch.py",
    "tools/repro_lint_torch.py",
]

SMALL = dict(root_grid=(1, 1, 1), cells_per_block=(4, 4, 4), max_level=1, nranks=1)


def test_import_leaves_jax_and_repro_unloaded():
    """Importing the port, its analyzer, its LM path (configs, models, the
    parameter converter, ``train`` with its checkpoints and expert
    placement, ``launch`` with the dry run and step analysis, ``sharding``), the
    cavity CLI, the example twins, the port's lint driver and
    ``tools/trace_report.py`` loads neither jax nor any module of the JAX
    package."""
    scripts = [EXAMPLE, *(REPO / t for t in TWINS), REPO / "tools" / "trace_report.py"]
    code = "\n".join([
        "import sys, importlib.util, repro_torch.lbm.driver, repro_torch.lbm.engines",
        "import repro_torch.kernels.lbm_collide.ops, repro_torch.state, repro_torch.serving",
        "import repro_torch.analysis, repro_torch.analysis.engine_plans",
        "import repro_torch.configs, repro_torch.models.zoo, repro_torch.models.convert, repro_torch.train",
        "import repro_torch.train.checkpoint, repro_torch.train.moe_balance",
        "import repro_torch.launch.perf_model, repro_torch.launch.mesh, repro_torch.launch.inputs",
        "import repro_torch.launch.step_analysis, repro_torch.launch.dryrun, repro_torch.sharding.specs",
        f"for i, path in enumerate({[str(p) for p in scripts]!r}):",
        "    spec = importlib.util.spec_from_file_location(f'script{i}', path)",
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))",
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.'))",
        "print(bad)",
        "sys.exit(1 if bad else 0)",
    ])
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


def test_chip_smoke_imports_neither_jax_nor_repro():
    names = _imports(REPO / "chip_smoke.py")
    assert "repro_torch.lbm.driver" in names
    for name in names:
        assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), f"chip_smoke.py imports {name}"


def test_cavity_cli_imports_neither_jax_nor_repro():
    names = _imports(EXAMPLE)
    assert "repro_torch.lbm.driver" in names
    for name in names:
        assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), f"{EXAMPLE.name} imports {name}"


@pytest.mark.parametrize("rel", TWINS)
def test_twin_imports_only_the_port(rel):
    names = _imports(REPO / rel)
    assert any(name.split(".")[0] == "repro_torch" for name in names), f"{rel} imports no repro_torch module"
    for name in names:
        assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), f"{rel} imports {name}"


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


def test_device_sharded_refuses_too_few_rank_devices():
    """Ranks take the first ``nranks`` rank devices and never wrap around:
    too few raise, naming both counts; a rank device of another type than
    the engine's is refused."""
    cfg = dict(SMALL, nranks=4, stepping_mode="device_sharded", device="cpu")
    with pytest.raises(RuntimeError, match=r"nranks=4 but 2 rank devices"):
        AMRLBM(LidDrivenCavityConfig(rank_devices=("cpu", "cpu"), **cfg))
    with pytest.raises(RuntimeError, match=r"nranks=3 but 0 rank devices"):
        resolve_rank_devices((), 3, torch.device("cpu"))
    assert resolve_rank_devices(("cpu",) * 5, 2, torch.device("cpu")) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="not a cpu device"):
        AMRLBM(LidDrivenCavityConfig(rank_devices=("cpu", "cuda:0", "cpu", "cpu"), **cfg))


def test_device_sharded_refuses_a_fabric_without_ppermute():
    sim = AMRLBM(LidDrivenCavityConfig(device="cpu", **dict(SMALL, nranks=2, stepping_mode="device_sharded")))
    sim.comm = Comm(2)
    with pytest.raises(TypeError, match="DeviceComm"):
        DeviceShardedEngine(sim)


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
    np.testing.assert_array_equal(D3Q19.c, D3Q27.c[:19])
    # the kernel's opposite_of (bounce-back, and the TRT loop over (q, q + 1)
    # pairs) is q + 1 for odd q and q - 1 for even q
    assert "return q == 0 ? 0 : ((q & 1) ? q + 1 : q - 1);" in src
    for lat in (D3Q19, D3Q27):
        opp = lat.opposite.tolist()
        assert opp == [0] + [q + 1 if q % 2 else q - 1 for q in range(1, lat.Q)]
    for name, lat in (("c_w19", D3Q19), ("c_w27", D3Q27)):
        w = [float(a) / float(b) for a, b in (t.split("/") for t in _cu_table(src, name))]
        assert w == lat.w.tolist(), name
