"""The port's indexed diffusion balancer against the copied one.

``IndexedDiffusionBalancer`` (``repro_torch.balancing``) keeps each rank's
connection strengths between selections instead of recomputing them from
the block ids for every candidate block. Every main iteration must return
the copy's assignments exactly, and the cycle must end in the copy's forest,
in the push, pull and alternating schemes, on random marks and on a
cavity's lid layers. The copy's cost is the fault it repairs: at 5^3 roots
it asks ``adjacency_kind`` for ten times more block pairs or more.
"""

import pytest

from repro_torch.balancing import IndexedDiffusionBalancer
from repro_torch.core import AMRPipeline, BlockDataRegistry, Comm, DiffusionBalancer, ForestGeometry, make_uniform_forest

from conftest import make_random_marks


class _Copy(DiffusionBalancer):
    def __call__(self, proxy, comm, iteration):
        assignments, again = super().__call__(proxy, comm, iteration)
        self.log.append(([dict(a) for a in assignments], again))
        return assignments, again


class _Indexed(IndexedDiffusionBalancer):
    def __call__(self, proxy, comm, iteration):
        assignments, again = super().__call__(proxy, comm, iteration)
        self.log.append(([dict(a) for a in assignments], again))
        return assignments, again


def _lid_marks(geom):
    """Refine every block that touches the top face: the cavity's lid."""
    top = geom.root_grid[2] << geom.max_level

    def mark(_rank, blocks):
        return {bid: b.level + 1 for bid, b in blocks.items() if geom.aabb(bid)[5] == top}

    return mark


CONTACTS = []


class _CountedGeometry(ForestGeometry):
    def adjacency_kind(self, a, b):
        CONTACTS.append(1)
        return super().adjacency_kind(a, b)


def _cycles(cls, mode, flows, roots, nranks, marks, cycles, weighted):
    geom = _CountedGeometry(root_grid=roots, max_level=8)
    CONTACTS.clear()
    forest = make_uniform_forest(geom, nranks, level=0)
    if weighted:
        for b in forest.all_blocks():
            b.weight = 1.0 + (b.bid % 5) * 0.25
    bal = cls(mode=mode, flow_iterations=flows, max_main_iterations=20)
    bal.log = []
    pipe = AMRPipeline(balancer=bal, registry=BlockDataRegistry.trivial())
    comm = Comm(nranks)
    forests = []
    for c in range(cycles):
        mark = _lid_marks(geom) if marks == "lid" else make_random_marks(c, p_coarsen=0.0)
        forest, _report = pipe.run_cycle(forest, comm, mark)
        forest.check_all()
        forests.append({(b.bid, b.level, b.owner) for b in forest.all_blocks()})
    return bal.log, forests, len(CONTACTS)


@pytest.mark.parametrize("mode, flows", [("push", 15), ("pull", 5), ("pushpull", 5)])
@pytest.mark.parametrize("marks, roots, nranks, weighted", [
    ("lid", (4, 4, 4), 4, False),
    ("random", (2, 2, 2), 8, True),
])
def test_indexed_balancer_assigns_as_the_copy(mode, flows, marks, roots, nranks, weighted):
    log, forests, _ = _cycles(_Copy, mode, flows, roots, nranks, marks, 2, weighted)
    got, got_forests, _ = _cycles(_Indexed, mode, flows, roots, nranks, marks, 2, weighted)
    assert sum(bool(a) for assignments, _again in log for a in assignments) > 0
    assert got == log
    assert got_forests == forests


def test_indexed_balancer_asks_for_far_fewer_contacts():
    _, _, copy_calls = _cycles(_Copy, "pushpull", 5, (5, 5, 5), 4, "lid", 2, False)
    _, _, calls = _cycles(_Indexed, "pushpull", 5, (5, 5, 5), 4, "lid", 2, False)
    assert calls * 10 < copy_calls, (calls, copy_calls)
