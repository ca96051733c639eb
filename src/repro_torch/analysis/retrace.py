"""Program-build sentinel: count the port's stepping-program builds and
hold them to a budget.

The JAX package's sentinel counts ``jax.jit`` traces. The port has no
tracer: its programs are Python closures over torch calls, and what an
engine pays for after an AMR event is the *build* of a program — ghost
plans, fill tables, device masks — which every keyed cache opens as a
``build:*`` span of category ``compile`` (``build:fused_superstep``,
``build:rank_programs``, ``build:device_programs``,
``build:ensemble_superstep``). :class:`RetraceSentinel` counts those spans
by name while it is active. A cache keyed on the storage version builds a
bounded number of programs per scenario (per arena version, never per
step); the per-engine budgets live in :data:`~.config.DEFAULTS`.

The sentinel counts whether telemetry is enabled or not, and changes
nothing the tracer records: it wraps the process-wide tracer's ``span``
for the ``with`` block and removes the wrapper on exit, even on error, so
the tracer's configuration and contents are what they would have been
without it (the zero-overhead disabled path included).
"""

from __future__ import annotations

from ..telemetry import get_tracer
from .findings import Finding

__all__ = ["RetraceSentinel", "budget_findings"]

_BUILD_PREFIX = "build:"
_BUILD_CAT = "compile"


class RetraceSentinel:
    """Context manager counting ``build:*`` spans of category ``compile``."""

    def __init__(self):
        self.counts: dict[str, int] = {}
        self._tracer = None
        self._shadowed = None

    def total(self) -> int:
        return sum(self.counts.values())

    def __enter__(self):
        tr = self._tracer = get_tracer()
        # an instance attribute shadows the class's method; keep any outer
        # sentinel's wrapper to restore (and chain) it
        self._shadowed = tr.__dict__.get("span")
        inner = tr.span
        counts = self.counts

        def counting_span(name, *, cat="default", **kw):
            if cat == _BUILD_CAT and name.startswith(_BUILD_PREFIX):
                counts[name] = counts.get(name, 0) + 1
            return inner(name, cat=cat, **kw)

        tr.span = counting_span
        return self

    def __exit__(self, *exc):
        tr = self._tracer
        if self._shadowed is None:
            del tr.span
        else:
            tr.span = self._shadowed
        return False


def budget_findings(label: str, counts: dict[str, int], budget: int) -> list[Finding]:
    """Compare measured program builds against an engine's build budget."""
    total = sum(counts.values())
    if total <= budget:
        return []
    worst = sorted(counts.items(), key=lambda kv: -kv[1])[:5]
    detail = ", ".join(f"{name}={n}" for name, n in worst)
    return [
        Finding(
            checker="retrace",
            severity="error",
            path=f"<retrace:{label}>",
            line=0,
            message=(
                f"engine '{label}' traced {total} times, budget is {budget} "
                f"(top tracers: {detail}) — a plan-cache version token is "
                "probably not keying a program cache, or a static arg is "
                "unstable"
            ),
            fix_hint="key program caches on arena.version; keep static args "
            "hashable and low-cardinality",
        )
    ]
