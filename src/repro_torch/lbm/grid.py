"""Per-block uniform grids declared through the typed field API (paper §3.3).

Every block stores a grid of the same size (paper Fig. 1), independent of its
level: ``(Q, nx+2, ny+2, nz+2)`` PDFs plus an ``(nx+2, ny+2, nz+2)`` cell-type
mask, with one ghost layer. Instead of hand-writing the six migration
callbacks per field (the seed's ``make_lbm_registry`` sextuples), each field
is one :class:`~repro.core.fields.FieldSpec` declaration; the
:class:`~repro.core.fields.FieldRegistry` derives migration, checkpoint, and
resilience behavior from it:

* ``pdf``  — ``refine="interpolate"``, ``coarsen="restrict"``: the volumetric
  copy/average pair of [54]/[16]. Split serializes the *unmodified* coarse
  octant and prolongs on the receiver (§3.3: "Only during deserialization,
  this data is distributed to and interpolated on the newly allocated, finer
  grids"); merge restricts (2x2x2 average) on the sender. Split followed by
  merge is the identity on cell averages — mass-conservative.
* ``mask`` — ``refine="inject"``, ``coarsen="max"``: every octet of fine
  cells takes the type of the coarse cell (§3.3 overlap consistency);
  merging prefers walls.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.blockid import ForestGeometry
from ..core.fields import FieldRegistry, FieldSpec
from .lattice import D3Q19, Lattice

__all__ = [
    "CellType",
    "LBMBlockSpec",
    "make_lbm_fields",
    "make_lbm_registry",
    "block_world_box",
]


class CellType:
    FLUID = 0
    WALL = 1
    LID = 2


@dataclass(frozen=True)
class LBMBlockSpec:
    cells: tuple[int, int, int] = (16, 16, 16)
    ghost: int = 1
    lattice: Lattice = D3Q19
    dtype: type = np.float32

    @property
    def pdf_shape(self) -> tuple[int, int, int, int]:
        nx, ny, nz = self.cells
        g = 2 * self.ghost
        return (self.lattice.Q, nx + g, ny + g, nz + g)

    @property
    def mask_shape(self) -> tuple[int, int, int]:
        nx, ny, nz = self.cells
        g = 2 * self.ghost
        return (nx + g, ny + g, nz + g)

    def interior(self, arr: np.ndarray) -> np.ndarray:
        g = self.ghost
        # explicit bounds: arr[g:-g] with g == 0 would be silently empty
        sl = tuple(slice(g, n - g) for n in arr.shape[-3:])
        return arr[(Ellipsis, *sl)]


def block_world_box(geom: ForestGeometry, bid: int) -> tuple[np.ndarray, np.ndarray]:
    """Block AABB in world units (one root block = unit cube)."""
    box = np.asarray(geom.aabb(bid), dtype=np.float64)
    scale = 1.0 / (1 << geom.max_level)
    return box[:3] * scale, box[3:] * scale


def make_lbm_fields(spec: LBMBlockSpec) -> FieldRegistry:
    """The whole LBM data declaration: two typed fields, nothing hand-rolled."""
    return FieldRegistry(
        cells=spec.cells,
        fields=(
            FieldSpec(
                "pdf",
                dtype=spec.dtype,
                shape=(spec.lattice.Q,),
                ghost=spec.ghost,
                refine="interpolate",
                coarsen="restrict",
            ),
            FieldSpec(
                "mask",
                dtype=np.int32,
                ghost=spec.ghost,
                refine="inject",
                coarsen="max",
            ),
        ),
    )


def make_lbm_registry(spec: LBMBlockSpec) -> FieldRegistry:
    """Backward-compatible name; the six callbacks are now derived."""
    return make_lbm_fields(spec)
