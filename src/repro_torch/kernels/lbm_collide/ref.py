"""Plain PyTorch versions of the fused LBM stream+collide step.

One fused update of a block array ``f`` of shape ``(..., Q, X, Y, Z)``
holding *post-collision* PDFs (a single block ``(Q, X, Y, Z)`` or a stack
``(B, Q, X, Y, Z)``; the ``q`` axis is always the fourth from last):

1. **pull streaming** with halfway bounce-back: the population arriving at
   cell ``x`` along ``c_q`` is ``f_q(x - c_q)`` if the source cell is fluid;
   if the source is a wall, it is the reflected own population
   ``f_opp(q)(x)`` plus the moving-wall momentum term
   ``6 w_q (c_q . u_wall)`` (velocity bounce-back, the moving lid);
2. **collision**: BGK or TRT (magic parameter 3/16).

Rolls wrap around the block's edges, so with an all-fluid mask the block
behaves as a fully periodic box; in the AMR driver the outermost layer is a
ghost layer refreshed by halo exchange before every step.

Cell types: 0 = fluid, 1 = no-slip obstacle, 2 = moving wall (``u_wall``).
Non-fluid cells keep their PDF values unchanged.

These are the oracles of the CUDA kernels in :mod:`.lbm_collide` and the
``"ref"`` backend of :mod:`.ops`; they match the JAX package's ``ref.py``
op for op, except that moments are summed by ``einsum``/``sum`` in PyTorch's
order (a few ulp apart from the kernels' fixed q order).
"""

from __future__ import annotations

import numpy as np
import torch

from ...lbm.lattice import D3Q19, Lattice

__all__ = [
    "stream_collide_ref",
    "stream_collide_coeffs",
    "stream_collide_halo_ref",
    "collision_coeffs",
    "precompute_stream_masks",
    "equilibrium",
    "moments",
    "CT_FLUID",
    "CT_WALL",
    "CT_LID",
]

CT_FLUID = 0
CT_WALL = 1
CT_LID = 2

_SPATIAL = (-3, -2, -1)


def moments(f: torch.Tensor, lattice: Lattice) -> tuple[torch.Tensor, torch.Tensor]:
    """Density (..., X,Y,Z) and velocity (..., 3,X,Y,Z) from PDFs (..., Q,X,Y,Z)."""
    c = torch.as_tensor(lattice.c, dtype=f.dtype, device=f.device)  # (Q,3)
    rho = f.sum(dim=-4)
    mom = torch.einsum("...qxyz,qd->...dxyz", f, c)
    u = mom / rho.unsqueeze(-4)
    return rho, u


def equilibrium(rho: torch.Tensor, u: torch.Tensor, lattice: Lattice) -> torch.Tensor:
    """Second-order Maxwell equilibrium, shape (..., Q, X, Y, Z)."""
    c = torch.as_tensor(lattice.c, dtype=rho.dtype, device=rho.device)  # (Q,3)
    w = torch.as_tensor(lattice.w, dtype=rho.dtype, device=rho.device)  # (Q,)
    cu = torch.einsum("qd,...dxyz->...qxyz", c, u)  # (...,Q,X,Y,Z)
    usq = (u * u).sum(dim=-4)  # (...,X,Y,Z)
    return w[:, None, None, None] * rho.unsqueeze(-4) * (
        1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq.unsqueeze(-4)
    )


def collision_coeffs(
    omega: float,
    *,
    lattice: Lattice = D3Q19,
    u_wall: tuple[float, float, float] = (0.0, 0.0, 0.0),
    collision: str = "bgk",
    magic: float = 3.0 / 16.0,
    dtype=np.float32,
) -> dict[str, np.ndarray]:
    """Host-derived per-step scalar coefficients for :func:`stream_collide_coeffs`.

    Every omega/u_wall-dependent quantity the stencil consumes is reduced
    here to a small set of dtype-precision scalars (and one ``(Q,)`` lid
    vector), computed in float64 and rounded to ``dtype`` once. The stencil
    (plain and CUDA alike) then only ever combines them as
    ``coefficient * tensor``, so passing them as per-member tensors (a later
    batched ensemble path) gives the same bits as passing scalars.
    """
    c = np.asarray(lattice.c)
    w = np.asarray(lattice.w)
    uw = np.asarray(u_wall, dtype=np.float64)
    # velocity bounce-back momentum term per direction: 6 w_q (c_q . u_wall)
    lid = np.array(
        [6.0 * w[q] * float(c[q] @ uw) for q in range(lattice.Q)], dtype=dtype
    )
    if collision == "bgk":
        return {"lid": lid, "om": dtype(omega)}
    if collision == "trt":
        tau_plus = 1.0 / omega
        tau_minus = magic / (tau_plus - 0.5) + 0.5
        return {
            "lid": lid,
            "om_p": dtype(1.0 / tau_plus),
            "om_m": dtype(1.0 / tau_minus),
        }
    raise ValueError(f"unknown collision model {collision!r}")


def precompute_stream_masks(mask, lattice: Lattice = D3Q19) -> dict[str, np.ndarray]:
    """Hoist the mask-derived streaming selectors out of the stencil.

    The cell-type mask only changes at AMR events, yet the stencil re-rolls
    it for every direction, every substep. This precomputes, on the host,
    exactly the booleans the stencil derives: ``fluid_src[q]`` /
    ``lid_src[q]`` are the rolled-mask comparisons for direction ``q``,
    ``fluid`` is the local-cell selector. Feeding them through
    :func:`stream_collide_coeffs`'s ``premask`` argument gives bitwise the
    same result.

    ``mask`` may be a single block ``(X, Y, Z)`` or a stack ``(B, X, Y, Z)``;
    rolls act on the trailing three axes and the ``q`` axis leads:
    ``fluid_src``/``lid_src`` are ``(Q, *mask.shape)`` bool.
    """
    m = np.asarray(mask)
    Q = lattice.Q
    c = np.asarray(lattice.c)
    fluid_src = np.empty((Q,) + m.shape, dtype=bool)
    lid_src = np.empty((Q,) + m.shape, dtype=bool)
    for q in range(Q):
        rolled = np.roll(
            m, shift=(int(c[q, 0]), int(c[q, 1]), int(c[q, 2])), axis=_SPATIAL
        )
        fluid_src[q] = rolled == CT_FLUID
        lid_src[q] = rolled == CT_LID
    return {"fluid_src": fluid_src, "lid_src": lid_src, "fluid": m == CT_FLUID}


def _coef(x, f: torch.Tensor) -> torch.Tensor:
    """A host coefficient as a tensor of ``f``'s dtype and device (exact:
    :func:`collision_coeffs` already rounded it to that dtype)."""
    return torch.as_tensor(x, dtype=f.dtype, device=f.device)


def stream_collide_coeffs(
    f: torch.Tensor,
    mask: torch.Tensor | None,
    coeffs: dict,
    *,
    lattice: Lattice = D3Q19,
    collision: str = "bgk",
    premask: dict | None = None,
) -> torch.Tensor:
    """One fused stream+collide step on ``f`` (..., Q, X, Y, Z).

    ``coeffs`` comes from :func:`collision_coeffs`. When ``premask`` (from
    :func:`precompute_stream_masks`, as tensors on ``f``'s device) is given,
    the mask rolls/compares are skipped in favour of the precomputed
    selectors and ``mask`` may be None.
    """
    Q = lattice.Q
    c = np.asarray(lattice.c)
    opp = np.asarray(lattice.opposite)
    lid = _coef(coeffs["lid"], f)

    # -- pull streaming with bounce-back ------------------------------------
    f_in = []
    for q in range(Q):
        sh = (int(c[q, 0]), int(c[q, 1]), int(c[q, 2]))
        pulled = torch.roll(f[..., q, :, :, :], shifts=sh, dims=_SPATIAL)
        if premask is not None:
            is_fluid_src = premask["fluid_src"][q]
            is_lid_src = premask["lid_src"][q]
        else:
            src_mask = torch.roll(mask, shifts=sh, dims=_SPATIAL)
            is_fluid_src = src_mask == CT_FLUID
            is_lid_src = src_mask == CT_LID
        bounced = f[..., int(opp[q]), :, :, :] + lid[q] * is_lid_src.to(f.dtype)
        f_in.append(torch.where(is_fluid_src, pulled, bounced))
    f_in = torch.stack(f_in, dim=-4)

    # -- collision -------------------------------------------------------------
    rho, u = moments(f_in, lattice)
    feq = equilibrium(rho, u, lattice)
    if collision == "bgk":
        f_out = f_in + _coef(coeffs["om"], f) * (feq - f_in)
    elif collision == "trt":
        om_p = _coef(coeffs["om_p"], f)
        om_m = _coef(coeffs["om_m"], f)
        opp_t = torch.as_tensor(opp, dtype=torch.long, device=f.device)
        f_opp_in = f_in.index_select(-4, opp_t)
        feq_opp = feq.index_select(-4, opp_t)
        f_plus = 0.5 * (f_in + f_opp_in)
        f_minus = 0.5 * (f_in - f_opp_in)
        feq_plus = 0.5 * (feq + feq_opp)
        feq_minus = 0.5 * (feq - feq_opp)
        f_out = f_in - om_p * (f_plus - feq_plus) - om_m * (f_minus - feq_minus)
    else:
        raise ValueError(f"unknown collision model {collision!r}")

    fluid = premask["fluid"] if premask is not None else mask == CT_FLUID
    return torch.where(fluid.unsqueeze(-4), f_out, f)


def stream_collide_ref(
    f: torch.Tensor,
    mask: torch.Tensor,
    omega: float,
    lattice: Lattice = D3Q19,
    u_wall: tuple[float, float, float] = (0.0, 0.0, 0.0),
    collision: str = "bgk",
    magic: float = 3.0 / 16.0,
) -> torch.Tensor:
    """One fused stream+collide step on a block (Q, X, Y, Z) or a stack
    (B, Q, X, Y, Z): the plain version of ``lbm_stream_collide``."""
    coeffs = collision_coeffs(
        omega,
        lattice=lattice,
        u_wall=u_wall,
        collision=collision,
        magic=magic,
        dtype=_np_dtype(f.dtype),
    )
    return stream_collide_coeffs(f, mask, coeffs, lattice=lattice, collision=collision)


def stream_collide_halo_ref(
    f: torch.Tensor,
    vals: torch.Tensor,
    dst_slot: torch.Tensor,
    dst_cell: torch.Tensor,
    coeffs: dict,
    *,
    mask: torch.Tensor | None = None,
    premask: dict | None = None,
    lattice: Lattice = D3Q19,
    collision: str = "bgk",
) -> torch.Tensor:
    """Ghost fill then stream+collide on a block stack (B, Q, X, Y, Z): the
    plain version of ``lbm_stream_collide_halo``.

    ``vals`` (N, Q) are written to flat cells ``dst_cell`` of blocks
    ``dst_slot`` of a copy of ``f`` (``f`` itself is left as it is), then the
    stencil runs on the filled copy with ``mask`` or ``premask``.
    """
    filled = f.clone()
    flat = filled.view(f.shape[0], f.shape[1], -1)
    flat[dst_slot, :, dst_cell] = vals
    return stream_collide_coeffs(
        filled, mask, coeffs, lattice=lattice, collision=collision, premask=premask
    )


def _np_dtype(dtype: torch.dtype):
    """The numpy scalar type of a floating torch dtype."""
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]
