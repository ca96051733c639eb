"""Deprecated: elasticity control moved to :mod:`repro.serving.elastic`.

The seed sketch that lived here (straggler EWMAs -> capacity-weighted bucket
reassignment, shrink planning) matured into the serving subsystem, where it
sits next to the data-plane resize (:func:`repro.serving.elastic.resize_ranks`)
it steers. This module re-exports the moved names so old imports keep
working, with a :class:`DeprecationWarning`; new code should import from
``repro.serving.elastic``.

One behavioral note: the moved ``StragglerMonitor.rebalance_buckets`` /
``plan_shrink`` default to the self-contained greedy-LPT assignment; pass
``assign=repro.train.data.diffusion_assign_buckets`` to restore the old
diffusion-balancer coupling.
"""

from __future__ import annotations

import warnings

from ..serving.elastic import (  # noqa: F401  (re-exports)
    ElasticPlan,
    StragglerMonitor,
    greedy_assign_buckets,
    plan_shrink,
)

__all__ = ["StragglerMonitor", "ElasticPlan", "plan_shrink", "greedy_assign_buckets"]

warnings.warn(
    "repro.train.elastic moved to repro.serving.elastic; this shim will be removed",
    DeprecationWarning,
    stacklevel=2,
)
