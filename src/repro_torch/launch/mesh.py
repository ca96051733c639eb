"""Production mesh construction, and the ambient mesh of a distributed model.

The twin of the JAX package's ``launch/mesh.py``. Topology: 16x16 = 256
ranks a pod; the multi-pod mesh prepends a "pod" axis (2 pods = 512
ranks). The ("data","model") axes stay within a pod; the "pod" axis
crosses pods, so the sharding specs keep per-layer collectives intra-pod
and leave only whole-gradient all-reduces to the pod axis (see
``repro_torch.sharding.specs``).

A ``DeviceMesh`` needs a process group of the mesh's size. On a machine
without that many cards, ``fake_process_group`` starts torch's ``fake``
backend, whose collectives move no data: the dry run places meta tensors
on such a mesh to count each rank's bytes and collectives.

``mesh_scope(mesh)`` is the reference's ``with mesh:``: an active
``DistContext`` constrains its DTensors on the mesh of the innermost
scope, and inside the scope the tensors the model creates itself (rope
tables, masks, accumulators) meet DTensors as replicated ones, in the
forward and the backward pass alike. On a mesh of three or more axes the
scope also places products, views, pointwise operations and the
embedding's index by one fixed rule
(``repro_torch.sharding.fixed_placements``), where DTensor's own planning
took more than 20 s a product.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from typing import Iterator

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = [
    "make_production_mesh",
    "mesh_axes",
    "mesh_devices",
    "mesh_axis_sizes",
    "fake_process_group",
    "mesh_scope",
    "current_mesh",
]


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) with "pod" first, over the
    default process group, which must have 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def mesh_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def mesh_devices(mesh: DeviceMesh) -> int:
    return int(mesh.size())


def mesh_axis_sizes(mesh: DeviceMesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """The default process group as rank 0 of ``world_size`` ranks on torch's
    ``fake`` backend (collectives return at once and move nothing),
    destroyed on exit. Only meshes of ``device_type="cpu"`` live on it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers the "fake" backend

    dist.init_process_group("fake", store=FakeStore(), world_size=world_size, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


_SCOPES: list[DeviceMesh] = []
# the fewest mesh axes on which ``mesh_scope`` places operations by
# ``repro_torch.sharding.fixed_placements``
FIXED_PLACEMENTS_FROM_AXES = 3


def current_mesh() -> DeviceMesh | None:
    """The mesh of the innermost ``mesh_scope``, or None outside any."""
    return _SCOPES[-1] if _SCOPES else None


@contextmanager
def mesh_scope(mesh: DeviceMesh) -> Iterator[DeviceMesh]:
    """Run a model with an active ``DistContext`` on ``mesh``. Inside, plain
    tensors that meet DTensors in an operation count as replicated (DTensor's
    implicit replication); torch's own ``implicit_replication`` clears that
    flag on exit, so this scope restores the value it found and scopes nest.
    On a mesh of three or more axes, the operations that
    ``repro_torch.sharding.fixed_placements.FixedPlacements`` covers are
    placed by it while the scope is open; a 1-D or 2-D mesh leaves them to
    DTensor."""
    from torch.distributed.tensor import DTensor

    from ..sharding.fixed_placements import FixedPlacements

    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    _SCOPES.append(mesh)
    rule = FixedPlacements(mesh) if mesh.ndim >= FIXED_PLACEMENTS_FROM_AXES else nullcontext()
    try:
        with rule:
            yield mesh
    finally:
        _SCOPES.pop()
        dispatcher._allow_implicit_replication = before
