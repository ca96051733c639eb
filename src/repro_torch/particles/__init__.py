"""Lagrangian particle subsystem of the PyTorch port: meshless block data on
the AMR forest.

Passive tracers live as per-block variable-length struct-of-arrays sets and
ride the migration machinery unchanged (:mod:`.storage`, a whole copy of the
JAX package's), advect through the block-local LBM velocity field with an
RK2 step in plain PyTorch ops on the engine's device (:mod:`.advect`), hop
blocks/ranks through batched p2p messages over the Comm fabric
(:mod:`.redistribute`), and feed a ``cells + alpha * N`` load model into the
dynamic balancers (:mod:`.balance`). ``storage``, ``balance`` and
``redistribute`` are jax-free copies; ``advect`` is rewritten on torch.

Driver integration: pass ``LidDrivenCavityConfig(particles=ParticlesConfig(...))``.
"""

from .storage import (
    PARTICLE_FIELDS,
    ParticlesConfig,
    all_particles,
    block_box,
    concat_particles,
    empty_particles,
    find_leaf,
    num_particles,
    particles_nbytes,
    register_particles,
    seed_particles,
    sort_by_id,
    take,
    total_particles,
)
from .advect import advect_block_batch
from .balance import particle_block_weight, particle_proxy_weight
from .redistribute import apply_domain_boundary, redistribute_particles

__all__ = [
    "PARTICLE_FIELDS",
    "ParticlesConfig",
    "all_particles",
    "block_box",
    "concat_particles",
    "empty_particles",
    "find_leaf",
    "num_particles",
    "particles_nbytes",
    "register_particles",
    "seed_particles",
    "sort_by_id",
    "take",
    "total_particles",
    "advect_block_batch",
    "particle_block_weight",
    "particle_proxy_weight",
    "apply_domain_boundary",
    "redistribute_particles",
]
