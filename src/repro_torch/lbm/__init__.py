"""Lattice Boltzmann substrate (paper §3, §5).

D3Q19/D3Q27 lattices, BGK and TRT collision operators, halfway bounce-back
(no-slip) and velocity bounce-back (moving lid) boundaries, per-block uniform
grids with ghost layers, the volumetric coarse<->fine PDF conversion used
during dynamic refinement (paper §3.3, [54]/[16]), the velocity-gradient
refinement criterion (§3.1), and the AMR-coupled simulation driver.
"""

from .lattice import D3Q19, D3Q27, Lattice
from .grid import CellType, LBMBlockSpec, make_lbm_fields, make_lbm_registry

__all__ = [
    "D3Q19",
    "D3Q27",
    "Lattice",
    "CellType",
    "LBMBlockSpec",
    "make_lbm_fields",
    "make_lbm_registry",
    "AMRLBM",
    "LidDrivenCavityConfig",
]


def __getattr__(name):  # lazy: avoids kernels<->lbm circular import
    if name in ("AMRLBM", "LidDrivenCavityConfig"):
        from .driver import AMRLBM, LidDrivenCavityConfig

        return {"AMRLBM": AMRLBM, "LidDrivenCavityConfig": LidDrivenCavityConfig}[name]
    raise AttributeError(name)
