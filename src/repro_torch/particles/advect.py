"""Lagrangian advection on PyTorch: trilinear velocity interpolation + RK2.

The counterpart of the JAX package's jitted advection
(``repro/particles/advect.py``), as plain PyTorch ops on the engine's
device. One call advects all particles of one (level, block-batch) group: it
gathers the PDF stack's eight surrounding cells per particle, forms the
macroscopic velocity per corner, trilinearly blends, takes an RK2 midpoint
sample, and returns the end-of-step lattice velocity per particle. Positions
are integrated on the host in float64.

**Cross-batch determinism.** The sharded engines batch per rank while the
host modes batch a whole level, so the same particle must produce bitwise
identical results under different batch shapes. The Q-sum over the
populations and the 8-corner trilinear blend are fixed-order chains of
elementwise adds, and everything else per particle is elementwise or a
gather, so the batch shape cannot influence a particle's arithmetic.

**Transfers.** The pdf stack arrives as numpy (host modes, and the device
modes after ``materialize_host``) or as a tensor. Whatever is not already a
tensor on ``device`` is uploaded once per call, and the velocities come back
once; ``traffic``, when given, adds those bytes to its ``"h2d"`` and
``"d2h"`` entries.

**Units.** World space: one root block = unit cube. A level-l block spans
``2**-l`` per axis with ``n`` cells, and substeps ``2**l`` times per coarse
step, so a lattice velocity ``u`` (cells/substep) is a world displacement of
``u * 2**l * h_l = u / n`` per coarse step — *level-independent*. In the
sampler's own (ghosted cell-index) coordinates the midpoint offset is
``0.5 * dt * 2**l * u`` cells. With one ghost layer, cell centers span
``[-g+0.5, n+g-0.5]``, so trilinear interpolation is defined everywhere in
the block and midpoint excursions are clamped to that hull.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.forest import Block
from .storage import block_box, num_particles

__all__ = ["advect_block_batch", "gather_batch", "scatter_batch"]


def _next_pow2(n: int) -> int:
    return 1 << max(3, (n - 1).bit_length())


def _sample(pdf: torch.Tensor, mask: torch.Tensor, slot: torch.Tensor, xi: torch.Tensor, c: np.ndarray):
    """Fluid-masked macroscopic velocity (N, 3) at positions ``xi``
    (ghosted cell-center coordinates, f32), trilinear over the 8
    surrounding cells of block ``slot`` of the (B, Q, X, Y, Z) stack."""
    Q = pdf.shape[1]
    dims = pdf.shape[-3:]
    i0 = [torch.clamp(torch.floor(xi[:, d]).long(), 0, dims[d] - 2) for d in range(3)]
    t = [torch.clamp(xi[:, d] - i0[d].to(xi.dtype), 0.0, 1.0) for d in range(3)]
    out = None
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ix, iy, iz = i0[0] + dx, i0[1] + dy, i0[2] + dz
                f = pdf[slot, :, ix, iy, iz]  # (N, Q) corner populations
                # fixed-order chained Q-sums
                rho = f[:, 0]
                for q in range(1, Q):
                    rho = rho + f[:, q]
                u = []
                for d in range(3):
                    m = f[:, 0] * float(c[0, d])
                    for q in range(1, Q):
                        m = m + f[:, q] * float(c[q, d])
                    u.append(m / torch.clamp_min(rho, 1e-12))
                fluid = (mask[slot, ix, iy, iz] == 0).to(xi.dtype)
                w = (
                    (t[0] if dx else 1.0 - t[0])
                    * (t[1] if dy else 1.0 - t[1])
                    * (t[2] if dz else 1.0 - t[2])
                ) * fluid
                term = torch.stack([w * u[d] for d in range(3)], dim=1)
                out = term if out is None else out + term  # canonical order
    return out


def _advect(pdf, mask, xi, slot, step_cells: float, dt: float, c: np.ndarray) -> torch.Tensor:
    """RK2 midpoint: the end-of-step lattice velocity (N, 3)."""
    u1 = _sample(pdf, mask, slot, xi, c)
    half = torch.tensor(0.5 * dt, dtype=xi.dtype) * torch.tensor(step_cells, dtype=xi.dtype)
    xi_mid = xi + half.to(xi.device) * u1
    return _sample(pdf, mask, slot, xi_mid, c)


def gather_batch(
    blocks: list[Block],
    slots: dict[int, int],
    name: str = "particles",
) -> tuple[np.ndarray, np.ndarray, list[tuple[Block, int]]]:
    """Concatenate the particle positions of a block batch (ascending bid)
    into one (N, 3) array with a per-particle buffer-slot index. Returns
    ``(pos, slot, layout)`` where ``layout`` records per-block counts for
    :func:`scatter_batch`."""
    blocks = sorted(blocks, key=lambda b: b.bid)
    pos_parts, slot_parts, layout = [], [], []
    for b in blocks:
        p = b.data.get(name)
        n = num_particles(p)
        layout.append((b, n))
        if n:
            pos_parts.append(p["pos"])
            slot_parts.append(np.full(n, slots[b.bid], dtype=np.int32))
    if not pos_parts:
        return np.empty((0, 3)), np.empty((0,), np.int32), layout
    return np.concatenate(pos_parts), np.concatenate(slot_parts), layout


def scatter_batch(
    layout: list[tuple[Block, int]],
    pos: np.ndarray,
    vel: np.ndarray,
    name: str = "particles",
) -> None:
    """Write advected positions/velocities back per block (same order that
    :func:`gather_batch` concatenated them in)."""
    off = 0
    for b, n in layout:
        if n:
            p = b.data[name]
            b.data[name] = {"pos": pos[off : off + n], "vel": vel[off : off + n], "id": p["id"]}
            off += n


def _on(a, device: torch.device, traffic: dict | None) -> torch.Tensor:
    """``a`` as a tensor on ``device``; a numpy array or a tensor elsewhere
    is copied there, and its bytes are counted as an upload."""
    t = torch.as_tensor(a)
    if isinstance(a, np.ndarray) or t.device != device:
        if traffic is not None:
            traffic["h2d"] += t.numel() * t.element_size()
        t = t.to(device)
    return t


def advect_block_batch(
    pdf: np.ndarray | torch.Tensor,
    mask: np.ndarray | torch.Tensor,
    lattice,
    geom,
    blocks: list[Block],
    slots: dict[int, int],
    *,
    level: int,
    cells: tuple[int, int, int],
    ghost: int,
    dt: float = 1.0,
    name: str = "particles",
    device: torch.device | str | None = None,
    traffic: dict | None = None,
) -> int:
    """Advect all particles of a block batch against its (B, Q, X, Y, Z) PDF
    stack (numpy or a tensor) for one coarse step.

    ``slots`` maps bid -> stack slot (arena slot index, or position in an
    ad-hoc restack). The sampler runs on ``device`` (default: ``pdf``'s own
    device for a tensor, the CPU for numpy). Positions integrate on the host
    in float64 from the sampler's float32 velocities; the particle's stored
    ``vel`` is the end-of-step world velocity. Returns the number of
    particles advected."""
    pos, slot, layout = gather_batch(blocks, slots, name)
    n = pos.shape[0]
    if n == 0:
        return 0
    if device is None:
        device = pdf.device if isinstance(pdf, torch.Tensor) else "cpu"
    device = torch.device(device)
    ncells = np.asarray(cells, dtype=np.float64)
    lo_of = np.zeros((max(slots[b.bid] for b, _n in layout) + 1, 3))
    for b, _cnt in layout:
        lo_of[slots[b.bid]] = block_box(geom, b.bid)[0]
    h = (2.0 ** -level) / ncells  # world cell size per axis on this level
    # ghosted cell-center coordinates (f64 on host, f32 into the sampler):
    xi64 = (pos - lo_of[slot]) / h - 0.5 + ghost
    # pad to a pow2 length, as the JAX package bounds its jit specializations
    npad = _next_pow2(n)
    xi = np.full((npad, 3), float(ghost), dtype=np.float32)
    xi[:n] = xi64.astype(np.float32)
    slot_pad = np.zeros(npad, dtype=np.int64)
    slot_pad[:n] = slot
    c32 = np.ascontiguousarray(lattice.c, dtype=np.float32)
    u = _advect(
        _on(pdf, device, traffic),
        _on(mask, device, traffic),
        _on(xi, device, traffic),
        _on(slot_pad, device, traffic),
        2.0**level,
        dt,
        c32,
    )
    u = u[:n].cpu().numpy().astype(np.float64)
    if traffic is not None:
        traffic["d2h"] += n * 3 * 4
    vel_world = u / ncells  # per coarse time unit, level-independent
    scatter_batch(layout, pos + dt * vel_world, vel_world, name)
    return n
