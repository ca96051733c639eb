"""Every cell of every reduced arch through the port's dry run on a fake
(2, 2, 2) ("pod", "data", "model") mesh, traced (``run_cell``), as the
reference lowers every cell on its (2, 16, 16) mesh:

* each rank's argument bytes equal, byte for byte, the reference's specs
  applied to its ``jax.eval_shape`` trees, and ``model_flops`` and
  ``hbm_bytes_estimate`` equal the reference's (``assert_traced_cell``);
* the step's counted FLOPs (DTensor operations at their global shapes:
  the cluster's) equal the same step's on one device (plain meta tensors,
  remat) with the (2, 2) mesh's token groups and microbatches, which the
  (2, 2) mesh's trace counts: rank 0's FLOPs x 8 here equal rank 0's x 4
  there. The port counts an operation at its global shape, so a dimension
  sharded unevenly (replicated, by ``_sanitize``) cannot make them differ;
  a moe layer's token groups (one a batch shard: 4 here, 2 there) could,
  where its capacity is clamped, and at these sizes do not.

As on every mesh, ``mesh_scope`` places products, views and pointwise ops by
``repro_torch.sharding.fixed_placements``. Each cell's sequence is cut to 32 and
its batch to 8 (``long_500k`` keeps its batch of 1). The fake process group
lives for the module, so the cells share DTensor's plans of each operation
signature.
"""

import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh

from repro.configs import get_config as jax_get_config
from repro_torch.configs import all_arch_ids, cells_for, get_config
from repro_torch.launch.dryrun import _microbatches, run_cell
from repro_torch.launch.mesh import fake_process_group
from torch_dryrun_cases import assert_traced_cell, cut, one_device_flops

AXES, SIZES = ("pod", "data", "model"), {"pod": 2, "data": 2, "model": 2}
GROUPS_2X2 = 2  # the (2, 2) mesh's batch shards


@pytest.fixture(scope="module")
def mesh():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with fake_process_group(8):
        yield init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=AXES)
    torch.set_num_threads(before)


@pytest.mark.parametrize("arch", all_arch_ids())
def test_every_cell_traces_on_a_2x2x2_mesh(mesh, arch):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    for shape in map(cut, cells_for(cfg)):
        res = run_cell(cfg, shape, mesh, verbose=False)
        assert_traced_cell(res, jcfg, shape, AXES, SIZES)
        assert res["mesh"] == "multi" and res["n_chips"] == 8
        flops = one_device_flops(cfg, shape, GROUPS_2X2, _microbatches(cfg, shape, GROUPS_2X2))
        assert res["flops"]["counted_cluster"] == flops, (arch, shape.shape_id)
