"""Telemetry: per-rank span tracing, bounded metrics, Chrome-trace export.

One instrumentation layer shared by every subsystem (the AMReX-TinyProfiler
role for this repo): the AMR pipeline stages, the stepping engines' substep
phases, halo plan builds, host<->device residency traffic, compile events,
and the serving job lifecycle all record into one process-wide
:class:`~repro.telemetry.tracer.Tracer`.

Design rules (the paper's bounded-metadata discipline, applied to
observability):

* **Bounded everywhere.** Every rank records into its own fixed-capacity
  ring buffer — old records are evicted (and the eviction counted), never
  accumulated; metric label sets are capped per metric. Per-rank telemetry
  memory is therefore independent of rank count and run length, the Table-1
  property.
* **Near-zero cost when disabled.** ``span()`` returns a shared no-op
  context manager when tracing is off; ``stage()`` always times (it replaces
  the hand-rolled ``perf_counter``/``StageStats`` idiom) but records
  nothing. An overhead test pins the disabled path.
* **One clock.** All timestamps come from the tracer's injectable ``clock``
  (default ``time.perf_counter``), so latency tests can substitute a fake
  clock and every ``StageStats.seconds`` is derivable from the spans that
  produced it — the two surfaces cannot disagree.

Usage::

    from repro import telemetry
    telemetry.configure(enabled=True)
    sim.run(8)
    telemetry.export.write_chrome_trace("trace.json")
    # then: python tools/trace_report.py trace.json
"""

from . import export
from .metrics import (
    BYTES_BUCKETS,
    SECONDS_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from .tracer import NULL_SPAN, Span, SpanRecord, Tracer, configure, get_tracer

__all__ = [
    "BYTES_BUCKETS",
    "SECONDS_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_SPAN",
    "Span",
    "SpanRecord",
    "Tracer",
    "configure",
    "export",
    "get_tracer",
]
