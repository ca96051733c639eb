"""Protocol verification of the exchange plans a stepping engine holds.

:mod:`.protocol` proves compiled plans correct by index arithmetic; this
module hands it the plans a live engine actually steps with, with the
engine's own slot maps (an arena's slots need not be the sorted-bid
assignment of :func:`~.protocol.rank_slot_map`):

* ``fused`` — the ghost plan of every activity pattern of the current
  superstep, through :func:`~.protocol.verify_ghost_plan`;
* ``fused_sharded`` — the compiled rank plan of every activity pattern of
  the current rank programs, through
  :func:`~.protocol.verify_compiled_rank_plan`.

``verify_ghost_plan`` keys its expected ghost targets by block owner and
then folds the owners into one key, keeping only the last owner's targets,
so on a forest spread over several ranks it reports the other owners'
targets as extra writes (the JAX package's copy does the same). A
single-arena plan does not depend on owners, so its targets are computed
here on :func:`one_owner_view` of the forest: the same blocks, levels and
adjacency, every block on rank 0.
"""

from __future__ import annotations

from ..core.forest import BlockForest
from .findings import Finding
from .protocol import verify_compiled_rank_plan, verify_ghost_plan

__all__ = ["one_owner_view", "verify_engine_plans"]


def one_owner_view(forest: BlockForest) -> BlockForest:
    """The forest's topology with every block (and neighbour link) on rank 0."""
    view = BlockForest(forest.geom, 1)
    for b in forest.all_blocks():
        c = b.clone_shallow()
        c.owner = 0
        c.neighbors = dict.fromkeys(b.neighbors, 0)
        view.insert(c)
    return view


def verify_engine_plans(sim) -> list[Finding]:
    """Verify the plans ``sim.engine`` steps the current forest with (built
    first if the forest changed since the last step, as the next step would)."""
    eng = sim.engine
    mode = eng.mode
    findings: list[Finding] = []
    if mode == "fused":
        eng._fused_program()
        slots, plans = eng.held_plans
        view = one_owner_view(sim.forest)
        for p, plan in plans.items():
            findings += verify_ghost_plan(view, sim.fields, plan, slots, path=f"<fused:pattern {p}>")
    elif mode == "fused_sharded":
        progs = eng._programs()
        for p, plan in progs.plans.items():
            findings += verify_compiled_rank_plan(
                sim.forest, sim.fields, plan, progs.rank_slots, path=f"<fused_sharded:pattern {p}>"
            )
    else:
        raise ValueError(f"no held plans to verify in stepping mode {mode!r}")
    return findings
