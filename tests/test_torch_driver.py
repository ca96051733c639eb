"""Whole runs of the port against the JAX package, on the conformance
suite's ``BASE`` scenario (2^3 roots, 8^3 cells, ``max_level=1``, 8 coarse
steps with AMR every 4; the JAX side on ``kernel_backend="ref"``).

Each torch mode must grow the same forest (block ids, levels, owners) after
every AMR event, and end with the same interior density and velocity
within the f32 kernel tolerance and the same mass within 1e-6 relative
(the two frameworks sum moments in different orders). Then one coarse step
is taken from state carried across with :mod:`repro_torch.state`, so a
refinement decision that flips on round-off cannot hide a kernel fault.
"""

import numpy as np
import pytest

from repro.lbm import AMRLBM as JaxAMRLBM
from repro.lbm import LidDrivenCavityConfig as JaxConfig
from repro_torch.lbm.criteria import macroscopic
from repro_torch.lbm.driver import AMRLBM, LidDrivenCavityConfig
from repro_torch.state import export_state, load_state

BASE = dict(
    root_grid=(2, 2, 2),
    cells_per_block=(8, 8, 8),
    omega=1.5,
    u_lid=(0.08, 0.0, 0.0),
    max_level=1,
    refine_upper=0.03,
    refine_lower=0.004,
)
COARSE_STEPS = 8
AMR_INTERVAL = 4
TOL = dict(rtol=3e-5, atol=3e-6)


def _forest(sim) -> set:
    return {(b.bid, b.level, b.owner) for b in sim.forest.all_blocks()}


def _run(sim) -> list[set]:
    """``sim.run`` unrolled, recording the forest after every AMR event."""
    forests = []
    for i in range(COARSE_STEPS):
        sim.advance(1)
        if (i + 1) % AMR_INTERVAL == 0:
            sim.adapt()
            forests.append(_forest(sim))
    return forests


@pytest.fixture(scope="module")
def reference():
    sim = JaxAMRLBM(JaxConfig(nranks=4, stepping_mode="restack", kernel_backend="ref", **BASE))
    return sim, _run(sim)


def _assert_interiors_close(sim, ref_sim) -> None:
    sim.materialize_host()
    ref_sim.materialize_host()
    ref = {b.bid: b for b in ref_sim.forest.all_blocks()}
    sl = (slice(1, -1),) * 3
    for b in sim.forest.all_blocks():
        rho, u = macroscopic(b.data["pdf"], sim.spec.lattice)
        rho_r, u_r = macroscopic(ref[b.bid].data["pdf"], sim.spec.lattice)
        np.testing.assert_allclose(rho[sl], rho_r[sl], **TOL)
        np.testing.assert_allclose(u[(Ellipsis, *sl)], u_r[(Ellipsis, *sl)], **TOL)


@pytest.mark.parametrize("mode", ["restack", "arena", "fused"])
def test_mode_matches_jax_restack(reference, mode):
    ref_sim, ref_forests = reference
    sim = AMRLBM(LidDrivenCavityConfig(nranks=4, stepping_mode=mode, device="cpu", **BASE))
    forests = _run(sim)
    assert sim.amr_cycles >= 1 and len(sim.forest.levels_in_use()) > 1
    assert forests == ref_forests
    _assert_interiors_close(sim, ref_sim)
    m, m_ref = sim.total_mass(), ref_sim.total_mass()
    assert abs(m - m_ref) / m_ref < 1e-6


def test_one_step_from_carried_state_matches_jax():
    jax_sim = JaxAMRLBM(JaxConfig(nranks=4, stepping_mode="restack", kernel_backend="ref", **BASE))
    jax_sim.advance(AMR_INTERVAL)
    jax_sim.adapt()
    assert len(jax_sim.forest.levels_in_use()) > 1
    state = export_state(jax_sim)
    sim = AMRLBM(LidDrivenCavityConfig(nranks=4, stepping_mode="fused", device="cpu", **BASE))
    load_state(sim, state)
    assert _forest(sim) == _forest(jax_sim)
    sim.arena.check_consistent(sim.forest)
    sim.forest.check_all()
    jax_sim.advance(1)
    sim.advance(1)
    _assert_interiors_close(sim, jax_sim)


def test_load_state_refuses_another_geometry():
    sim = AMRLBM(LidDrivenCavityConfig(nranks=4, stepping_mode="restack", device="cpu", **BASE))
    state = export_state(sim)
    state["cells_per_block"] = (4, 4, 4)
    with pytest.raises(ValueError, match="geometry"):
        load_state(sim, state)
