"""What one step of a distributed model does: its FLOPs and its collectives.

The port's counterpart of the JAX package's ``launch/hlo_analysis.py``,
written anew: that module parses XLA's HLO text, which the port never
produces, and its hardware constants are a TPU's. Here the step runs
eagerly (on meta tensors for a dry run) under two dispatch modes:

* ``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs of every
  product. It counts a DTensor operation at its global shape, so the
  FLOPs are the whole cluster's, not one rank's;
* ``_CollectiveBytes`` sums, per kind, the operand bytes and the count of
  every collective the step issues on this rank: the functional
  collectives (``_c10d_functional``) that DTensor's redistributions call,
  which ``torch.distributed.tensor.debug.CommDebugMode`` counts, and the
  in-place ``c10d`` ones. Each collective's first tensor operand is its
  operand, as the reference's parser takes the first operand's shape.
  A mode's handler runs with the modes above it suspended, and a DTensor
  operation runs below every mode, so what moves inside an operation is
  counted where it is made: DTensor's redistributions of an operation's
  operands (the dispatcher's ``redistribute_local_args``, wrapped while
  the step runs) and those of a mode entered before the step
  (``mesh_scope``'s fixed placements on a 3-axis mesh) run inside
  ``counting_collectives``.

``roofline_terms`` keeps the reference's signature and keys, at the
published rates of one NVIDIA H100 SXM 80GB (``HW``).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["HW", "StepStats", "analyze_step", "counting_collectives", "roofline_terms"]


class HW:
    """NVIDIA H100 SXM 80GB, per card (NVIDIA's data sheet, dense rates)."""

    PEAK_FLOPS_BF16 = 989e12
    HBM_BW = 3.35e12
    NVLINK_BW = 450e9  # per direction
    IB_BW = 50e9  # one 400 Gb/s InfiniBand port per GPU, across nodes


# collective op names (without namespace and overload) by kind
_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}


@dataclass
class StepStats:
    """FLOPs (the cluster's) and this rank's collectives of one step."""

    flops: float = 0.0
    collective_bytes: dict[str, float] = field(default_factory=dict)
    collective_count: dict[str, int] = field(default_factory=dict)

    @property
    def collective_bytes_total(self) -> float:
        return sum(self.collective_bytes.values())


class _CollectiveBytes(TorchDispatchMode):
    """Sums operand bytes and counts of the collectives dispatched under it."""

    def __init__(self, stats: StepStats):
        super().__init__()
        self.stats = stats

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        ns = func.namespace
        kind = _KINDS.get(func._opname) if ns in ("_c10d_functional", "c10d") else None
        if kind is not None:
            first = next(t for t in tree_leaves((args, kwargs or {})) if isinstance(t, torch.Tensor))
            nbytes = sum(t.numel() * t.element_size() for t in (first if isinstance(first, list) else [first]))
            self.stats.collective_bytes[kind] = self.stats.collective_bytes.get(kind, 0.0) + nbytes
            self.stats.collective_count[kind] = self.stats.collective_count.get(kind, 0) + 1
        return func(*args, **(kwargs or {}))


_OPEN: list[StepStats] = []  # the stats of each running ``analyze_step``, innermost last


@contextmanager
def counting_collectives() -> Iterator[None]:
    """The collectives issued inside are counted into the innermost running
    ``analyze_step``'s stats (nothing is counted outside one). For a
    dispatch mode entered before the step, whose handler runs while the
    step's own counter is suspended."""
    if not _OPEN:
        yield
        return
    with _CollectiveBytes(_OPEN[-1]):
        yield


@contextmanager
def _counting_dtensor_moves() -> Iterator[None]:
    """DTensor's dispatcher redistributes an operation's operands inside
    ``counting_collectives`` while the scope is open."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    own = vars(dispatcher).get("redistribute_local_args")
    inner = dispatcher.redistribute_local_args

    def counted(*args, **kwargs):
        with counting_collectives():
            return inner(*args, **kwargs)

    dispatcher.redistribute_local_args = counted
    try:
        yield
    finally:
        if own is None:
            del dispatcher.redistribute_local_args
        else:
            dispatcher.redistribute_local_args = own


def analyze_step(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` run once under the FLOP counter and the
    collective counter: returns (its result, ``StepStats``)."""
    stats = StepStats()
    flop_mode = FlopCounterMode(display=False)
    _OPEN.append(stats)
    try:
        with _counting_dtensor_moves(), flop_mode, _CollectiveBytes(stats):
            out = fn(*args, **kwargs)
    finally:
        _OPEN.pop()
    stats.flops = float(flop_mode.get_total_flops())
    return out, stats


def roofline_terms(
    *,
    flops_per_device: float,
    hbm_bytes_per_device: float,
    collective_bytes_per_device: float,
    dcn_bytes_per_device: float = 0.0,
    n_pods: int = 1,
) -> dict:
    """Seconds a step takes at best on each resource, from per-device
    quantities (SPMD: per-device time is step time), at ``HW``'s rates:
    compute at the bf16 peak, memory at HBM3's rate, collectives at one
    NVLink direction's rate and, across pods, InfiniBand's. A 16-wide axis
    spans two 8-card NVLink nodes, so part of its traffic crosses
    InfiniBand: ``collective_s`` is a lower bound. The FLOPs of
    ``analyze_step`` are the cluster's (``FlopCounterMode`` counts DTensor
    operations at their global shapes); divide them by the ranks first."""
    compute_s = flops_per_device / HW.PEAK_FLOPS_BF16
    memory_s = hbm_bytes_per_device / HW.HBM_BW
    coll_s = collective_bytes_per_device / HW.NVLINK_BW
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
    }
    if n_pods > 1 and dcn_bytes_per_device:
        terms["dcn_s"] = dcn_bytes_per_device / HW.IB_BW
    dominant = max(terms, key=lambda k: terms[k])
    terms["dominant"] = dominant
    terms["bound_s"] = terms[dominant]
    # roofline fraction: useful compute time over the bound
    terms["roofline_fraction"] = compute_s / max(terms["bound_s"], 1e-30)
    return terms
