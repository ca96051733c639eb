"""The port's Lagrangian tracers, on the particle conformance scenario of the
JAX package's ``tests/test_particles.py`` (2^3 roots, 8^3 cells,
``max_level=1``, 24 tracers a block under the lid, AMR at coarse steps 4
and 8, then a forced load-balancing cycle and one more coarse step).

* ``restack``, ``sharded`` and ``fused_sharded`` at 1, 4 and 13 ranks give
  the same ids, positions and velocities within 1e-10 (bitwise in practice:
  the pdf interiors are bitwise equal across the modes and the advection's
  arithmetic does not depend on the batch), with the population conserved.
* Against the JAX package's ``restack`` with tracers: the same forest and
  ids, and positions within 1e-6. Over the 9 coarse steps of the scenario
  the two frameworks' f32 pdfs drift apart by the kernel tolerance (rtol
  3e-5); a tracer moves ``u / n`` per coarse step (u <= 0.08 lattice
  units, n = 8 cells), so a relative velocity error of 3e-5 moves it at
  most about 3e-7 after 9 steps.
* One coarse step with tracers from state carried across with
  :mod:`repro_torch.state` agrees within 1e-8: only one step's f32
  rounding separates the two, about 1e-9 of displacement.
* The tracer step's host<->device traffic is counted: a device-resident
  mode flushes its pdf stacks and the advection uploads each batch.
"""

import numpy as np
import pytest
import torch

from repro.lbm import AMRLBM as JaxAMRLBM
from repro.lbm import LidDrivenCavityConfig as JaxConfig
from repro.particles import ParticlesConfig as JaxParticlesConfig
from repro.particles import all_particles as jax_all_particles
from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
from repro_torch.particles import ParticlesConfig, all_particles, block_box, num_particles
from repro_torch.particles.advect import _next_pow2
from repro_torch.state import export_state, load_state

PHYSICS = dict(
    root_grid=(2, 2, 2),
    cells_per_block=(8, 8, 8),
    omega=1.5,
    u_lid=(0.08, 0.0, 0.0),
    max_level=1,
    refine_upper=0.03,
    refine_lower=0.004,
)
TRACERS = dict(per_block=24, seed=1, alpha=0.05, region=((0.0, 0.0, 1.7), (2.0, 2.0, 2.0)))
COARSE_STEPS = 8
AMR_INTERVAL = 4


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The suite runs its files in parallel worker processes; one PyTorch
    intra-op thread a worker keeps the OpenMP pools of several workers from
    oversubscribing the cores (about 8x slower with the default pools)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _forest(sim) -> set:
    return {(b.bid, b.level, b.owner) for b in sim.forest.all_blocks()}


def _torch(mode, nranks, **over):
    return AMRLBM(LidDrivenCavityConfig(
        nranks=nranks, stepping_mode=mode, device="cpu", particles=ParticlesConfig(**TRACERS), **PHYSICS, **over
    ))


def _jax(nranks):
    return JaxAMRLBM(JaxConfig(
        nranks=nranks, stepping_mode="restack", kernel_backend="ref",
        particles=JaxParticlesConfig(**TRACERS), **PHYSICS,
    ))


def _scenario(sim) -> list[set]:
    """AMR events at steps 4/8, then a forced load-balancing cycle and one
    more coarse step; the forest after each event."""
    n0 = sim.total_particles()
    assert n0 > 0
    forests = []
    for i in range(COARSE_STEPS):
        sim.advance(1)
        if (i + 1) % AMR_INTERVAL == 0:
            sim.adapt()
            forests.append(_forest(sim))
    sim.adapt(force_rebalance=True)
    forests.append(_forest(sim))
    sim.advance(1)
    assert sim.total_particles() == n0, "particle count must be exactly conserved"
    return forests


@pytest.fixture(scope="module")
def reference():
    sim = _torch("restack", 1)
    _scenario(sim)
    return sim


@pytest.mark.parametrize(
    "mode, nranks",
    [("sharded", 1), ("sharded", 4), ("sharded", 13), ("fused_sharded", 1), ("fused_sharded", 4),
     ("fused_sharded", 13), ("restack", 4)],
)
def test_tracers_agree_across_modes_and_ranks(reference, mode, nranks):
    sim = _torch(mode, nranks)
    _scenario(sim)
    assert sim.amr_cycles >= 1
    ref, got = all_particles(reference.forest), all_particles(sim.forest)
    np.testing.assert_array_equal(got["id"], ref["id"])
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got["vel"], ref["vel"], rtol=0, atol=1e-10)
    assert sim.particles_moved == reference.particles_moved > 0
    if nranks == 13:
        st = sim.data_stats["particles"]
        assert st.p2p_bytes > 0 and st.p2p_messages > 0 and st.collective_bytes_per_rank == 0


def test_tracers_match_jax_restack():
    jax_sim = _jax(4)
    want_forests = _scenario(jax_sim)
    sim = _torch("fused_sharded", 4)
    assert _scenario(sim) == want_forests
    assert sim.particles_moved == jax_sim.particles_moved
    ref, got = jax_all_particles(jax_sim.forest), all_particles(sim.forest)
    np.testing.assert_array_equal(got["id"], ref["id"])
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=0, atol=1e-6)
    # every tracer sits inside its block after redistribution
    for b in sim.forest.all_blocks():
        p = b.data["particles"]
        lo, hi = block_box(sim.geom, b.bid)
        assert np.all((p["pos"] >= lo) & (p["pos"] < hi)), hex(b.bid)


@pytest.mark.parametrize("mode", ["restack", "fused_sharded"])
def test_one_tracer_step_from_carried_state_matches_jax(mode):
    jax_sim = _jax(4)
    jax_sim.advance(AMR_INTERVAL)
    jax_sim.adapt()
    assert len(jax_sim.forest.levels_in_use()) > 1
    state = export_state(jax_sim)
    sim = _torch(mode, 4)
    load_state(sim, state)
    assert _forest(sim) == _forest(jax_sim)
    before = all_particles(sim.forest)
    np.testing.assert_array_equal(before["pos"], jax_all_particles(jax_sim.forest)["pos"])
    jax_sim.advance(1)
    sim.advance(1)
    ref, got = jax_all_particles(jax_sim.forest), all_particles(sim.forest)
    np.testing.assert_array_equal(got["id"], ref["id"])
    assert np.abs(got["pos"] - before["pos"]).max() > 1e-4, "the tracers moved"
    np.testing.assert_allclose(got["pos"], ref["pos"], rtol=0, atol=1e-8)


def test_state_refuses_tracers_the_simulation_does_not_run():
    with_tracers = export_state(_torch("restack", 4))
    plain = AMRLBM(LidDrivenCavityConfig(nranks=4, stepping_mode="restack", device="cpu", **PHYSICS))
    with pytest.raises(ValueError, match="tracers"):
        load_state(plain, with_tracers)
    with pytest.raises(ValueError, match="tracers"):
        load_state(_torch("restack", 4), export_state(plain))


def test_tracer_step_counts_its_transfers():
    """A device-resident mode's tracer step flushes the pdf stacks (d2h) and
    the advection uploads each rank's batch (h2d) and downloads the
    velocities; between tracer steps the stepping itself moves nothing."""
    sim = _torch("fused_sharded", 4)
    arenas = sim.arenas.per_rank
    assert all(a.levels() == [0] for a in arenas)
    held = [sum(num_particles(b.data["particles"]) for b in sim.forest.local_blocks(r).values()) for r in range(4)]
    sim.advance(1)
    # one flush of every rank's pdf stack, and the velocities of every
    # tracer come back; every rank holding tracers uploads its pdf and mask
    # stacks, its padded f32 positions and its int64 slots
    uploads = sum(
        a.buffer(0, "pdf").nbytes + a.buffer(0, "mask").nbytes + _next_pow2(n) * (3 * 4 + 8)
        for a, n in zip(arenas, held) if n
    )
    flush = sum(a.buffer(0, "pdf").nbytes for a in arenas)
    assert sim.particle_transfer_bytes == {"h2d": uploads, "d2h": flush + 12 * sum(held)}
    res = sim.engine.residencies()
    counts = [(x.h2d_transfers, x.d2h_transfers) for x in res]
    sim.engine.advance(2)
    assert [(x.h2d_transfers, x.d2h_transfers) for x in res] == counts
