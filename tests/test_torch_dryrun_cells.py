"""Every cell of every reduced arch through the port's dry run on a fake
(2, 2) ("data", "model") mesh, traced (``run_cell``): each rank's argument
bytes equal, byte for byte, the reference's specs applied to its
``jax.eval_shape`` trees, ``model_flops`` and ``hbm_bytes_estimate`` equal
the reference's, and the step's trace counts FLOPs and roofline terms.

Each cell's sequence is cut to 32 and its batch to 8 (``long_500k`` keeps
its batch of 1). The fake process group lives for the module, so the
cells share DTensor's plans of each operation signature.
"""

import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh

from repro.configs import get_config as jax_get_config
from repro_torch.configs import all_arch_ids, cells_for, get_config
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import fake_process_group
from torch_dryrun_cases import assert_traced_cell, cut

AXES, SIZES = ("data", "model"), {"data": 2, "model": 2}


@pytest.fixture(scope="module")
def mesh():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with fake_process_group(4):
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=AXES)
    torch.set_num_threads(before)


@pytest.mark.parametrize("arch", all_arch_ids())
def test_every_cell_traces_on_a_2x2_mesh(mesh, arch):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    for shape in map(cut, cells_for(cfg)):
        res = run_cell(cfg, shape, mesh, verbose=False)
        assert_traced_cell(res, jcfg, shape, AXES, SIZES)
