"""PyTorch/CUDA port of the block-structured AMR lattice-Boltzmann system.

Mirrors the layout of the JAX package ``repro``: ``core`` (forest, AMR
pipeline, balancing, migration, typed fields), ``lbm`` (lattice, grids, halo
plans, stepping engines, driver), ``kernels.lbm_collide`` (the hand-written
CUDA stream+collide kernels and their plain PyTorch versions) and
``telemetry``. The jax-free modules are whole copies of their ``repro``
originals; the data plane is rewritten on tensors with an explicit
``device``. Nothing here imports ``jax`` or ``repro``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
