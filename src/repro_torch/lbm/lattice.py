"""LBM velocity sets: D3Q19 (paper §5.1.1) and D3Q27 (paper §5.2)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Lattice", "D3Q19", "D3Q27"]


@dataclass(frozen=True)
class Lattice:
    name: str
    c: np.ndarray  # (Q, 3) int8 lattice velocities
    w: np.ndarray  # (Q,) float64 weights
    opposite: np.ndarray  # (Q,) int — index of -c_q

    @property
    def Q(self) -> int:
        return len(self.w)

    cs2: float = 1.0 / 3.0


def _make(name: str, vels: list[tuple[int, int, int]], weights: list[float]) -> Lattice:
    c = np.array(vels, dtype=np.int8)
    w = np.array(weights, dtype=np.float64)
    assert abs(w.sum() - 1.0) < 1e-12, w.sum()
    opp = np.array(
        [next(i for i, v in enumerate(vels) if v == (-x, -y, -z)) for x, y, z in vels],
        dtype=np.int32,
    )
    return Lattice(name=name, c=c, w=w, opposite=opp)


_D3Q19_VELS = [
    (0, 0, 0),
    (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1),
    (1, 1, 0), (-1, -1, 0), (1, -1, 0), (-1, 1, 0),
    (1, 0, 1), (-1, 0, -1), (1, 0, -1), (-1, 0, 1),
    (0, 1, 1), (0, -1, -1), (0, 1, -1), (0, -1, 1),
]
_D3Q19_W = [1 / 3] + [1 / 18] * 6 + [1 / 36] * 12

_D3Q27_VELS = _D3Q19_VELS + [
    (1, 1, 1), (-1, -1, -1), (1, 1, -1), (-1, -1, 1),
    (1, -1, 1), (-1, 1, -1), (1, -1, -1), (-1, 1, 1),
]
_D3Q27_W = [8 / 27] + [2 / 27] * 6 + [1 / 54] * 12 + [1 / 216] * 8

D3Q19 = _make("D3Q19", _D3Q19_VELS, _D3Q19_W)
D3Q27 = _make("D3Q27", _D3Q27_VELS, _D3Q27_W)


def omega_for_level(omega_coarse: float, level: int) -> float:
    """Relaxation rate on refined grids (acoustic scaling, dx,dt halve per
    level): tau_l - 1/2 = 2^l (tau_0 - 1/2)."""
    tau0 = 1.0 / omega_coarse
    tau_l = 0.5 + (2.0**level) * (tau0 - 0.5)
    return 1.0 / tau_l
