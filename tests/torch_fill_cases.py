"""Forests whose ghost fills hold every segment kind, for the port's fill
tests (imports no jax: the card tests use it too).

``refined_forest`` (from the port) grows a forest of two roots and refines
one root and then one of its children; ``branch_fills`` compiles the fused
superstep's ghost plan of every activity pattern, so each branch's merged
fills carry ``same``, ``fine`` and ``coarse`` segments.
"""

import torch

from repro_torch.lbm.forests import refined_forest
from repro_torch.lbm.halo import compile_ghost_plan, lower_halo_fill

__all__ = ["refined_forest", "branch_fills", "random_buffers"]


def branch_fills(forest, reg, slots) -> list[dict]:
    """The merged fills (level -> LevelHaloFill) of every activity pattern
    of the fused superstep, as ``FusedEngine`` compiles them."""
    levels = sorted(slots)
    lmax = levels[-1]
    return [
        lower_halo_fill(
            compile_ghost_plan(forest, reg, slots, fields=("pdf",), levels={l for l in levels if l >= lmax - p})
        )
        for p in range(lmax + 1)
    ]


def random_buffers(rng, arena, Q, dtype, device="cpu") -> list[torch.Tensor]:
    """One random (B, Q, X, Y, Z) pdf stack per level, ascending."""
    out = []
    for l in arena.levels():
        B = arena.num_blocks(l)
        dims = arena.buffer(l, "pdf").shape[2:]
        a = (0.05 + 0.01 * rng.standard_normal((B, Q, *dims))).astype(dtype)
        out.append(torch.from_numpy(a).to(device))
    return out
