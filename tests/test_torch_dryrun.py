"""The port's dry run (``repro_torch.launch.dryrun``) and step analysis
(``repro_torch.launch.step_analysis``), on the CPU.

* ``analyze_step``: a chain of products counts 2·M·N·K FLOPs each; an
  all-gather of a known shard on a fake 4-rank mesh counts its operand
  bytes, whether it is called, made by DTensor inside an operation, or
  made by the fixed placements of a 3-axis mesh. ``roofline_terms``: the
  reference's dominance leg at the H100's rates.
* ``run_cell`` at full size, qwen2-0.5b ``train_4k`` and ``decode_32k`` on
  a fake 16 x 16 mesh: OK, each rank's argument bytes equal, byte for
  byte, to the reference's specs applied to its ``jax.eval_shape`` trees
  (each leaf's shape divided by its axes' sizes, times its itemsize), and
  ``model_flops`` equal to the reference's.
* qwen2-0.5b ``decode_32k`` at full size on a fake (2, 16, 16) mesh,
  traced: the same bytes, and every product counted once. Reduced
  qwen2-0.5b ``train_4k`` on fake (2, 2) and (2, 2, 2) meshes: each kind
  of collective bytes a rank within a factor 2 of the other mesh's.
* Every reduced arch's cells on a fake (2, 2, 2) mesh, each cell's
  sequence cut to 32 and its batch to 8 (``long_500k`` keeps its batch of
  1), placed without a trace: argument bytes held the same way.
  ``tests/test_torch_dryrun_cells.py`` traces every such cell on a fake
  (2, 2) mesh, ``tests/test_torch_dryrun_multi.py`` on the (2, 2, 2) one.
"""

import math

import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import get_config as jax_get_config
from repro_torch.configs import SHAPES, all_arch_ids, cells_for, get_config
from repro_torch.launch.dryrun import main, run_cell
from repro_torch.launch.mesh import fake_process_group, make_production_mesh, mesh_scope
from repro_torch.launch.step_analysis import HW, analyze_step, roofline_terms
from torch_dryrun_cases import assert_bytes, assert_traced_cell, cut


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- step analysis -----------------------------------------------------------------


def test_a_chain_of_products_counts_2mnk_each():
    a, b, c = torch.randn(32, 48), torch.randn(48, 16), torch.randn(16, 8)
    out, stats = analyze_step(lambda x, y, z: (x @ y) @ z, a, b, c)
    assert out.shape == (32, 8)
    assert stats.flops == 2 * 32 * 48 * 16 + 2 * 32 * 16 * 8
    assert stats.collective_bytes == {} and stats.collective_bytes_total == 0


def test_an_all_gather_counts_its_operand_bytes():
    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        x = DTensor.from_local(torch.zeros(1024, 64), mesh, [Shard(0)], run_check=False)
        full, stats = analyze_step(x.full_tensor)
    assert tuple(full.shape) == (4096, 64)
    assert stats.collective_bytes == {"all-gather": 1024 * 64 * 4}
    assert stats.collective_count == {"all-gather": 1}


def test_an_operation_counts_the_collectives_dtensor_makes_inside_it():
    """A softmax over the sharded dimension: DTensor gathers the operand
    inside the operation, below the counter's mode, and it is counted."""
    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
        x = DTensor.from_local(torch.zeros(1024, 64), mesh, [Shard(0)], run_check=False)
        y, stats = analyze_step(torch.softmax, x, 0)
    assert y.placements == (Replicate(),)
    assert stats.collective_bytes == {"all-gather": 1024 * 64 * 4}
    assert stats.collective_count == {"all-gather": 1}


def test_the_fixed_placements_count_their_own_collectives():
    """On a fake (2, 2, 2) mesh ``mesh_scope`` places a product by the
    fixed rule: ``a``'s rows on "pod" and "data", ``b``'s contraction on
    "data" and its columns on "model", so ``b`` is gathered on "data" (its
    (3, 2) f32 shard) inside the rule's handler, and counted; no other
    collective is made."""
    with fake_process_group(8):
        mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
        a = DTensor.from_local(torch.zeros(2, 6), mesh, [Shard(0), Shard(0), Replicate()], run_check=False)
        b = DTensor.from_local(torch.zeros(3, 2), mesh, [Replicate(), Shard(0), Shard(1)], run_check=False)
        with mesh_scope(mesh):
            out, stats = analyze_step(torch.matmul, a, b)
    assert out.placements == (Shard(0), Shard(0), Shard(1)) and tuple(out.shape) == (8, 4)
    assert stats.collective_bytes == {"all-gather": 3 * 2 * 4}
    assert stats.collective_count == {"all-gather": 1}


def test_roofline_terms_dominance():
    t = roofline_terms(
        flops_per_device=HW.PEAK_FLOPS_BF16,  # 1 second of compute
        hbm_bytes_per_device=HW.HBM_BW * 0.5,
        collective_bytes_per_device=0.0,
    )
    assert HW.PEAK_FLOPS_BF16 == 989e12 and HW.HBM_BW == 3.35e12 and HW.NVLINK_BW == 450e9 and HW.IB_BW == 50e9
    assert t["dominant"] == "compute_s"
    assert abs(t["compute_s"] - 1.0) < 1e-9
    assert 0.99 < t["roofline_fraction"] <= 1.0
    t2 = roofline_terms(
        flops_per_device=HW.PEAK_FLOPS_BF16 * 0.1,
        hbm_bytes_per_device=0.0,
        collective_bytes_per_device=HW.NVLINK_BW * 4,  # 4 seconds on the links
    )
    assert t2["dominant"] == "collective_s"
    assert t2["roofline_fraction"] < 0.05
    t3 = roofline_terms(flops_per_device=0.0, hbm_bytes_per_device=0.0, collective_bytes_per_device=0.0,
                        dcn_bytes_per_device=HW.IB_BW, n_pods=2)
    assert t3["dominant"] == "dcn_s" and abs(t3["dcn_s"] - 1.0) < 1e-9


# -- the dry run -------------------------------------------------------------------


@pytest.mark.parametrize("shape_id", ["train_4k", "decode_32k"])
def test_qwen2_cells_at_full_size_on_the_production_mesh(shape_id):
    with fake_process_group(256):
        mesh = make_production_mesh(device_type="cpu")
        res = run_cell("qwen2-0.5b", shape_id, mesh, verbose=False)
    assert_traced_cell(res, jax_get_config("qwen2-0.5b"), SHAPES[shape_id], ("data", "model"), {"data": 16, "model": 16})
    assert res["n_chips"] == 256 and res["microbatches"] == (2 if shape_id == "train_4k" else 1)
    if shape_id == "decode_32k":  # every product of one decode step, no remat
        assert res["flops"]["counted_cluster"] == res["flops"]["model_cluster"]


def test_qwen2_decode_at_full_size_on_the_multi_pod_mesh():
    """qwen2-0.5b ``decode_32k`` traced on a fake (2, 16, 16) mesh, where
    ``mesh_scope`` places products, views and pointwise operations by the fixed
    rule: argument bytes the reference's, every product of the step counted
    once (``train_4k`` there takes about 70 s: ``PERF.md`` section 6)."""
    sizes = {"pod": 2, "data": 16, "model": 16}
    with fake_process_group(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        res = run_cell("qwen2-0.5b", "decode_32k", mesh, verbose=False)
    assert_traced_cell(res, jax_get_config("qwen2-0.5b"), SHAPES["decode_32k"], ("pod", "data", "model"), sizes)
    assert res["n_chips"] == 512 and res["mesh"] == "multi"
    assert res["flops"]["counted_cluster"] == res["flops"]["model_cluster"]


def test_qwen2_train_collectives_against_the_2x2_mesh():
    """Reduced qwen2-0.5b ``train_4k`` traced on fake (2, 2) and (2, 2, 2)
    meshes. Every collective of the step is counted on both: the
    constraints', DTensor's inside an operation and, on (2, 2, 2), the
    fixed placements'. Twice the batch shards halve the activations a rank
    reduces and leave the weights it gathers, so each rank's gathered
    bytes and its reduced bytes (all-reduce and reduce-scatter: the rule
    reduces a partial sum where DTensor may scatter it) on (2, 2, 2) lie
    within a factor 2 of (2, 2)'s, and neither is 0."""
    cfg, shape = get_config("qwen2-0.5b").reduced(), cut(SHAPES["train_4k"])
    found = {}
    for dims, axes in (((2, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))):
        with fake_process_group(math.prod(dims)):
            mesh = init_device_mesh("cpu", dims, mesh_dim_names=axes)
            by_kind = run_cell(cfg, shape, mesh, verbose=False)["collectives"]["bytes_by_kind"]
        found[dims] = {"gathered": by_kind.get("all-gather", 0.0),
                       "reduced": by_kind.get("all-reduce", 0.0) + by_kind.get("reduce-scatter", 0.0)}
    for kind in ("gathered", "reduced"):
        ratio = found[(2, 2, 2)][kind] / found[(2, 2)][kind]
        assert found[(2, 2)][kind] > 0 and 0.5 <= ratio <= 2.0, (kind, found)


def test_every_reduced_arch_cell_placed_on_a_3d_mesh():
    """Every reduced arch's cells on a fake (2, 2, 2) ("pod", "data",
    "model") mesh, placed without a trace (``--no-trace``;
    ``tests/test_torch_dryrun_multi.py`` traces every such cell): argument
    bytes equal the reference's."""
    axes, sizes = ("pod", "data", "model"), {"pod": 2, "data": 2, "model": 2}
    with fake_process_group(8):
        mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=axes)
        for arch in all_arch_ids():
            cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
            for shape in map(cut, cells_for(cfg)):
                res = run_cell(cfg, shape, mesh, trace=False, verbose=False)
                assert_bytes(res, jcfg, shape, axes, sizes)
                assert res["mesh"] == "multi" and "roofline" not in res


def test_cli_writes_only_to_out(tmp_path, capsys):
    summary = main(["--arch", "qwen2-0.5b", "--shape", "decode_32k", "--out", str(tmp_path)])
    assert [row[3] for row in summary] == ["OK"]
    assert [p.name for p in tmp_path.iterdir()] == ["qwen2-0.5b__decode_32k__single.json"]
    assert "dry-run summary" in capsys.readouterr().out
