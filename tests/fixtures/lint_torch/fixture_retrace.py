"""Seeded violations for the port's static program-build checker (never
executed)."""

from repro_torch.kernels.lbm_collide.ops import make_fused_superstep, make_rank_absorb, make_rank_emit
from repro_torch.telemetry import get_tracer

_TR = get_tracer()


def build_every_step(pdfs, plans, coarse_steps):
    for _ in range(coarse_steps):
        fn = make_fused_superstep(**plans)  # TP-LOOP 12: one build a step
        pdfs = fn(pdfs)
    return pdfs


def build_per_rank(ranks, recvs):
    return [make_rank_absorb(recvs[r], None, {}) for r in ranks]  # TP-COMPREHENSION 18


def keyed_build(ranks, sends, version):
    with _TR.span("build:rank_programs", cat="compile", version=version):
        return {r: make_rank_emit(sends[r], {}, "cpu") for r in ranks}  # NEG-BUILD-SPAN 23


def make_device_superstep(ranks, sends):
    return [make_rank_emit(sends[r], {}, "cpu") for r in ranks]  # NEG-FACTORY 27: a composed program


def annotated(ranks, recvs):
    out = []
    for r in ranks:
        # repro: retrace-ok(fixture: bounded one-time build per rank)
        out.append(make_rank_absorb(recvs[r], None, {}))  # NEG-ANNOTATED 34
    return out
