"""The port's CUDA kernels on the card, held against their plain versions.

Imports no jax, so it runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tests marked ``gpu`` skip (inside the test) where there is no card. f32
compares at rtol 3e-5 / atol 3e-6 and f64 at 1e-12: the kernel sums the
moments in fixed q order, the plain version through ``einsum``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.lbm_collide.lbm_collide import (
    lbm_stream_collide,
    lbm_stream_collide_halo,
)
from repro_torch.kernels.lbm_collide.ops import _pad_fill_layout
from repro_torch.kernels.lbm_collide.ref import CT_LID, CT_WALL, stream_collide_ref
from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
from repro_torch.lbm.lattice import D3Q19, D3Q27

TOL = {np.float32: dict(rtol=3e-5, atol=3e-6), np.float64: dict(rtol=1e-11, atol=1e-12)}


def _random_state(rng, B, lattice, shape, dtype):
    w = np.asarray(lattice.w, dtype=dtype)
    f = w[None, :, None, None, None] * (
        1.0 + 0.05 * rng.standard_normal((B, lattice.Q, *shape))
    ).astype(dtype)
    mask = np.zeros((B, *shape), np.int32)
    mask[:, 0] = CT_WALL
    mask[:, -1] = CT_LID
    mask[:, :, 0] = CT_WALL
    return f, mask


def _random_halo(rng, B, lattice, dims, dtype):
    """Random distinct ghost-ring targets per block, padded per block."""
    X, Y, Z = dims
    ring = [
        (x * Y + y) * Z + z
        for x in range(X) for y in range(Y) for z in range(Z)
        if min(x, y, z) == 0 or x == X - 1 or y == Y - 1 or z == Z - 1
    ]
    slots, cells = [], []
    for b in range(B):
        pick = rng.choice(ring, size=3 + 4 * b, replace=False)
        slots += [b] * len(pick)
        cells += list(pick)
    vals = (rng.standard_normal((len(cells), lattice.Q)) * 0.01 + 0.05).astype(dtype)
    entry, cell, valid = _pad_fill_layout(np.asarray(slots), np.asarray(cells), B, dims)
    return vals[entry], cell, valid


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def test_cpu_tensors_take_the_plain_version_without_counting():
    rng = np.random.default_rng(0)
    f, mask = _random_state(rng, 2, D3Q19, (4, 4, 4), np.float32)
    before = lbm_stream_collide.launches
    got = lbm_stream_collide(torch.from_numpy(f), torch.from_numpy(mask), omega=1.3)
    want = stream_collide_ref(torch.from_numpy(f), torch.from_numpy(mask), omega=1.3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert lbm_stream_collide.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize(
    "lattice, collision, dtype, shape",
    [
        (D3Q19, "trt", np.float32, (10, 10, 10)),
        (D3Q27, "bgk", np.float32, (6, 8, 10)),
        (D3Q19, "bgk", np.float64, (5, 7, 3)),
        (D3Q27, "trt", np.float64, (4, 6, 5)),
    ],
    ids=["d3q19-trt-f32", "d3q27-bgk-f32", "d3q19-bgk-f64-odd", "d3q27-trt-f64-odd"],
)
def test_cuda_kernels_match_plain_on_card(lattice, collision, dtype, shape):
    _require_card()
    rng = np.random.default_rng(11)
    B = 3
    f, mask = _random_state(rng, B, lattice, shape, dtype)
    kw = dict(omega=1.4, lattice=lattice, collision=collision, u_wall=(0.05, 0.01, 0.0))
    fd, md = torch.from_numpy(f).cuda(), torch.from_numpy(mask).cuda()
    n0 = lbm_stream_collide.launches
    got = lbm_stream_collide(fd, md, **kw)
    torch.cuda.synchronize()
    assert lbm_stream_collide.launches == n0 + 1
    torch.testing.assert_close(got, stream_collide_ref(fd, md, **kw), **TOL[dtype])

    hv, cell, valid = (torch.from_numpy(a) for a in _random_halo(rng, B, lattice, shape, dtype))
    want = lbm_stream_collide_halo(fd.cpu(), md.cpu(), hv, cell, valid, **kw)
    n0 = lbm_stream_collide_halo.launches
    got = lbm_stream_collide_halo(fd.clone(), md, hv.cuda(), cell.cuda(), valid.cuda(), **kw)
    torch.cuda.synchronize()
    assert lbm_stream_collide_halo.launches == n0 + 1
    torch.testing.assert_close(got.cpu(), want, **TOL[dtype])


@pytest.mark.gpu
def test_fused_cuda_run_matches_restack_on_card():
    _require_card()
    base = dict(
        root_grid=(2, 2, 2), cells_per_block=(8, 8, 8), omega=1.5, u_lid=(0.08, 0.0, 0.0),
        max_level=1, refine_upper=0.03, refine_lower=0.004, nranks=1,
    )
    sims = {}
    for mode, backend in (("restack", "cuda"), ("fused", "cuda"), ("fused", "ref")):
        sim = AMRLBM(LidDrivenCavityConfig(stepping_mode=mode, kernel_backend=backend, **base))
        assert sim.device.type == "cuda"
        sim.run(8, amr_interval=4)
        sim.materialize_host()
        sims[mode, backend] = sim
    ref = sims["restack", "cuda"]
    want = {b.bid: ref.spec.interior(b.data["pdf"]) for b in ref.forest.all_blocks()}
    for sim in sims.values():
        got = {b.bid: sim.spec.interior(b.data["pdf"]) for b in sim.forest.all_blocks()}
        assert got.keys() == want.keys()
        for bid, arr in got.items():
            np.testing.assert_allclose(arr, want[bid], **TOL[np.float32])
