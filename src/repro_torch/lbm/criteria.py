"""Refinement criteria for the LBM (paper §3.1).

The velocity-gradient criterion used by the paper's example application
(§3.1/§5.2): per cell, sum the absolute values of all nine components of the
dimensionless velocity gradient (characteristic length 1, so only
subtractions are needed). A block is marked for refinement if the sum
exceeds an upper limit in *any* cell, and for potential coarsening if it
stays below a lower limit in *all* cells.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np

from ..core.forest import Block
from .grid import CellType, LBMBlockSpec
from .lattice import Lattice

__all__ = ["VelocityGradientCriterion", "macroscopic"]


def macroscopic(pdf: np.ndarray, lattice: Lattice) -> tuple[np.ndarray, np.ndarray]:
    """(rho, u) from a (Q, X, Y, Z) PDF array (numpy)."""
    c = lattice.c.astype(pdf.dtype)
    rho = pdf.sum(axis=0)
    u = np.einsum("qxyz,qd->dxyz", pdf, c) / np.maximum(rho, 1e-12)[None]
    return rho, u


@dataclass
class VelocityGradientCriterion:
    """Callable usable as the AMR pipeline's mark callback."""

    spec: LBMBlockSpec
    upper: float
    lower: float
    max_level: int
    min_level: int = 0

    def cell_indicator(self, blk: Block) -> np.ndarray:
        pdf = blk.data["pdf"]
        mask = blk.data["mask"]
        _rho, u = macroscopic(pdf, self.spec.lattice)
        u = u * (mask == CellType.FLUID)[None]
        s = np.zeros(u.shape[1:], dtype=np.float64)
        for d in range(3):  # velocity component
            for ax in (1, 2, 3):  # gradient direction
                grad = np.abs(np.diff(u[d], axis=ax - 1, append=np.take(u[d], [-1], axis=ax - 1)))
                s += grad
        return self.spec.interior(s)

    def __call__(self, _rank: int, blocks: Mapping[int, Block]) -> dict[int, int]:
        out: dict[int, int] = {}
        for bid, blk in blocks.items():
            s = self.cell_indicator(blk)
            if s.max(initial=0.0) > self.upper and blk.level < self.max_level:
                out[bid] = blk.level + 1
            elif s.max(initial=0.0) < self.lower and blk.level > self.min_level:
                out[bid] = blk.level - 1
        return out
