"""The port's stream+collide against the JAX package's, on the same inputs.

The plain PyTorch versions (and the kernel wrappers, which take them for
CPU tensors) are held against JAX ``stream_collide_ref`` over the
D3Q19/27 x bgk/trt x cube/rect/odd matrix, an omega sweep, f32 and f64 and
the wall/lid case, and against the Pallas kernels in interpret mode. The
moments are summed in another order on each side, so f32 compares at
rtol 3e-5 / atol 3e-6 and f64 at 1e-12, the tolerances of the JAX package's
own kernel tests. The CUDA kernels themselves are held against these plain
versions on the card by ``test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lbm_collide.lbm_collide import (
    lbm_stream_collide_halo_pallas,
    lbm_stream_collide_pallas,
)
from repro.kernels.lbm_collide.ops import fused_stream_collide
from repro_torch.kernels.lbm_collide.lbm_collide import (
    lbm_stream_collide,
    lbm_stream_collide_halo,
)
from repro_torch.kernels.lbm_collide.ops import _pad_fill_layout, make_halo_stream_collide
from repro_torch.kernels.lbm_collide.ref import (
    CT_LID,
    CT_WALL,
    collision_coeffs,
    stream_collide_ref,
)
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


def _jax_ref(f, mask, **kw):
    return np.asarray(fused_stream_collide(jnp.asarray(f), jnp.asarray(mask), backend="ref", **kw))


def _torch(fn, f, mask, **kw):
    return fn(torch.from_numpy(f), torch.from_numpy(mask), **kw).numpy()


@pytest.mark.parametrize("lattice", [D3Q19, D3Q27], ids=["d3q19", "d3q27"])
@pytest.mark.parametrize("collision", ["bgk", "trt"])
@pytest.mark.parametrize(
    "shape", [(4, 4, 4), (8, 6, 10), (5, 7, 3)], ids=["cube", "rect", "odd"]
)
def test_plain_matches_jax_ref(lattice, collision, shape):
    rng = np.random.default_rng(42)
    f, mask = _random_state(rng, 2, lattice, shape, np.float32)
    kw = dict(omega=1.55, lattice=lattice, collision=collision, u_wall=(0.04, 0.01, 0.0))
    want = _jax_ref(f, mask, **kw)
    np.testing.assert_allclose(_torch(stream_collide_ref, f, mask, **kw), want, **TOL[np.float32])
    # the kernel wrapper takes the same plain version for a CPU tensor
    np.testing.assert_allclose(_torch(lbm_stream_collide, f, mask, **kw), want, **TOL[np.float32])


@pytest.mark.parametrize("omega", [0.6, 1.0, 1.9])
def test_plain_omega_sweep(omega):
    rng = np.random.default_rng(0)
    f, mask = _random_state(rng, 3, D3Q19, (6, 6, 6), np.float32)
    want = _jax_ref(f, mask, omega=omega)
    np.testing.assert_allclose(_torch(stream_collide_ref, f, mask, omega=omega), want, **TOL[np.float32])


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_plain_dtype_sweep(dtype):
    rng = np.random.default_rng(7)
    f, mask = _random_state(rng, 1, D3Q19, (6, 6, 6), dtype)
    kw = dict(omega=1.2, lattice=D3Q19, collision="trt", u_wall=(0.05, 0.0, 0.02))
    with jax.enable_x64(dtype == np.float64):
        want = _jax_ref(f, mask, **kw)
    assert want.dtype == dtype
    got = _torch(lbm_stream_collide, f, mask, **kw)
    assert got.dtype == dtype
    np.testing.assert_allclose(got, want, **TOL[dtype])


def test_wall_cells_frozen_and_lid_injects_momentum():
    rng = np.random.default_rng(1)
    f, mask = _random_state(rng, 1, D3Q19, (8, 8, 8), np.float32)
    kw = dict(omega=1.5, u_wall=(0.1, 0.0, 0.0))
    out = _torch(stream_collide_ref, f, mask, **kw)
    np.testing.assert_allclose(out, _jax_ref(f, mask, **kw), **TOL[np.float32])
    solid = mask != 0
    np.testing.assert_array_equal(out[:, :, solid[0]], f[:, :, solid[0]])
    # the lid drags the fluid below it in +x
    c = torch.as_tensor(D3Q19.c, dtype=torch.float32)
    ux = torch.einsum("bqxyz,q->bxyz", torch.from_numpy(out), c[:, 0])
    assert float(ux[0, -2, 1:-1, 1:-1].mean()) > float(
        torch.einsum("bqxyz,q->bxyz", torch.from_numpy(f), c[:, 0])[0, -2, 1:-1, 1:-1].mean()
    )


@pytest.mark.parametrize(
    "lattice, collision", [(D3Q19, "trt"), (D3Q27, "bgk")], ids=["d3q19-trt", "d3q27-bgk"]
)
def test_wrapper_matches_pallas_interpret(lattice, collision):
    rng = np.random.default_rng(3)
    f, mask = _random_state(rng, 2, lattice, (5, 6, 4), np.float32)
    kw = dict(omega=1.3, lattice=lattice, collision=collision, u_wall=(0.06, -0.02, 0.0))
    want = np.asarray(
        lbm_stream_collide_pallas(jnp.asarray(f), jnp.asarray(mask), interpret=True, **kw)
    )
    np.testing.assert_allclose(_torch(lbm_stream_collide, f, mask, **kw), want, **TOL[np.float32])


def _random_halo(rng, B, lattice, dims, dtype, per_block=(7, 3)):
    """A random ghost fill: distinct ghost-ring cells per block, the merged
    (dst_slot, dst_cell, vals) form and its padded per-block layout."""
    X, Y, Z = dims
    ring = [
        (x * Y + y) * Z + z
        for x in range(X) for y in range(Y) for z in range(Z)
        if min(x, y, z) == 0 or x == X - 1 or y == Y - 1 or z == Z - 1
    ]
    slots, cells = [], []
    for b in range(B):
        pick = rng.choice(ring, size=per_block[b % len(per_block)], replace=False)
        slots += [b] * len(pick)
        cells += list(pick)
    dst_slot = np.asarray(slots, np.int32)
    dst_cell = np.asarray(cells, np.int32)
    vals = (rng.standard_normal((len(cells), lattice.Q)) * 0.01 + 0.05).astype(dtype)
    return dst_slot, dst_cell, vals


def test_halo_wrapper_matches_pallas_interpret():
    rng = np.random.default_rng(5)
    dims = (6, 5, 6)
    f, mask = _random_state(rng, 2, D3Q19, dims, np.float32)
    dst_slot, dst_cell, vals = _random_halo(rng, 2, D3Q19, dims, np.float32)
    entry, cell, valid = _pad_fill_layout(dst_slot, dst_cell, 2, dims)
    assert not valid.all(), "the layout must hold pad rows"
    hv = vals[entry]
    kw = dict(omega=1.45, lattice=D3Q19, collision="trt", u_wall=(0.08, 0.0, 0.0))
    want = np.asarray(
        lbm_stream_collide_halo_pallas(
            jnp.asarray(f), jnp.asarray(mask), jnp.asarray(hv), jnp.asarray(cell),
            jnp.asarray(valid), interpret=True, **kw,
        )
    )
    f_t = torch.from_numpy(f.copy())
    got = lbm_stream_collide_halo(
        f_t, torch.from_numpy(mask), torch.from_numpy(hv), torch.from_numpy(cell),
        torch.from_numpy(valid), **kw,
    ).numpy()
    np.testing.assert_allclose(got, want, **TOL[np.float32])
    np.testing.assert_array_equal(f_t.numpy(), f)  # the CPU path leaves f alone


def test_halo_backends_agree_bitwise_on_cpu():
    """The ``cuda`` backend's padded-slab layout and the ``ref`` backend's
    merged scatter + premask stencil give the same bits on the CPU."""
    rng = np.random.default_rng(9)
    dims = (6, 6, 6)
    f, mask = _random_state(rng, 3, D3Q19, dims, np.float32)
    dst_slot, dst_cell, vals = _random_halo(rng, 3, D3Q19, dims, np.float32, (5, 9, 2))
    kw = dict(mask=mask, omega=1.7, collision="trt", u_wall=(0.05, 0.0, 0.0), device="cpu")
    outs = [
        make_halo_stream_collide(dst_slot, dst_cell, backend=be, **kw)(
            torch.from_numpy(f.copy()), torch.from_numpy(vals)
        ).numpy()
        for be in ("cuda", "ref")
    ]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_coefficients_are_rounded_once_to_the_dtype():
    for dtype in (np.float32, np.float64):
        c = collision_coeffs(1.3, u_wall=(0.05, 0.0, 0.0), collision="trt", dtype=dtype)
        assert c["lid"].dtype == dtype and type(c["om_p"]) is dtype and type(c["om_m"]) is dtype
