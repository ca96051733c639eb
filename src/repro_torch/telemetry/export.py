"""Chrome-trace / Perfetto export and span -> stats aggregation.

Layout convention (load the JSON in ``chrome://tracing`` or
https://ui.perfetto.dev):

* **pid = rank.** Every simulated rank is one trace process; control-plane
  work that is not attributable to a single rank records under rank 0.
* **tid = subsystem.** Each span category ("amr", "stage", "substep",
  "halo.plan", "compile", "residency", "serving", ...) gets one thread per
  process, named accordingly.
* **Counter tracks.** Events carrying a ``bytes`` arg (residency h2d/d2h,
  route payloads) accumulate into per-(rank, category) byte counter tracks;
  ``compile``-category events accumulate into a compile-count track — the
  bytes/compiles timelines the paper-style breakdowns read.

The trace also embeds the bounded metrics snapshot and per-rank ring
accounting under ``"metadata"`` so ``tools/trace_report.py`` can render
per-pair p2p bytes and prove the buffers stayed bounded, from the artifact
alone.
"""

from __future__ import annotations

import json
from pathlib import Path

from .tracer import SpanRecord, Tracer, get_tracer

__all__ = [
    "to_chrome_trace",
    "write_chrome_trace",
    "stage_seconds",
    "stage_totals",
]

TRACE_VERSION = 1


def _tid_map(records: list[SpanRecord]) -> dict[str, int]:
    """Stable category -> tid assignment (sorted; tid 0 is metadata-only)."""
    return {cat: i + 1 for i, cat in enumerate(sorted({r.cat for r in records}))}


def to_chrome_trace(tracer: Tracer | None = None) -> dict:
    """Render the tracer's records as a Chrome-trace dict (JSON-ready)."""
    tr = tracer if tracer is not None else get_tracer()
    records = tr.records()
    tids = _tid_map(records)
    base = min((r.t0 for r in records), default=0.0)
    events: list[dict] = []
    ranks = sorted({r.rank for r in records})
    for rank in ranks:
        events.append(
            {
                "ph": "M", "pid": rank, "tid": 0, "name": "process_name",
                "args": {"name": f"rank {rank}"},
            }
        )
        events.append(
            {
                "ph": "M", "pid": rank, "tid": 0,
                "name": "process_sort_index", "args": {"sort_index": rank},
            }
        )
    seen_threads: set[tuple[int, int]] = set()
    counters: dict[tuple[int, str], float] = {}  # (rank, track) -> cumulative
    for rec in records:
        tid = tids[rec.cat]
        if (rec.rank, tid) not in seen_threads:
            seen_threads.add((rec.rank, tid))
            events.append(
                {
                    "ph": "M", "pid": rec.rank, "tid": tid,
                    "name": "thread_name", "args": {"name": rec.cat},
                }
            )
        ts = round((rec.t0 - base) * 1e6, 3)
        ev = {
            "ph": rec.ph, "pid": rec.rank, "tid": tid, "name": rec.name,
            "cat": rec.cat, "ts": ts,
        }
        if rec.ph == "X":
            ev["dur"] = round(rec.dur * 1e6, 3)
        else:
            ev["s"] = "t"
        if rec.args:
            ev["args"] = dict(rec.args)
        events.append(ev)
        # synthesized counter tracks
        nbytes = rec.args.get("bytes") if rec.args else None
        if isinstance(nbytes, (int, float)):
            key = (rec.rank, f"{rec.cat}.bytes")
            counters[key] = counters.get(key, 0) + nbytes
            events.append(
                {
                    "ph": "C", "pid": rec.rank, "tid": 0, "name": key[1],
                    "ts": ts, "args": {"bytes": counters[key]},
                }
            )
        if rec.cat == "compile":
            key = (rec.rank, "compiles")
            counters[key] = counters.get(key, 0) + 1
            events.append(
                {
                    "ph": "C", "pid": rec.rank, "tid": 0, "name": "compiles",
                    "ts": ts, "args": {"count": counters[key]},
                }
            )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "trace_version": TRACE_VERSION,
            "clock": "tracer",
            "ranks": ranks,
            "buffers": {str(k): v for k, v in tr.buffer_stats().items()},
            "metrics": tr.metrics.snapshot(),
        },
    }


def write_chrome_trace(path: str | Path, tracer: Tracer | None = None) -> Path:
    """Export the tracer to a Chrome-trace JSON file; returns the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(to_chrome_trace(tracer)) + "\n")
    return path


def stage_seconds(tracer: Tracer | None = None, *, cat: str = "stage") -> dict[str, float]:
    """Sum recorded span durations per name for one category, accumulating
    in recording order — the identical left-to-right float additions the
    ``StageStats`` surfaces perform, so a stage's span sum equals its
    ``data_stats`` seconds *exactly* (pinned by tests/test_telemetry.py)."""
    tr = tracer if tracer is not None else get_tracer()
    out: dict[str, float] = {}
    for rec in tr.records():
        if rec.ph == "X" and rec.cat == cat:
            out[rec.name] = out.get(rec.name, 0.0) + rec.dur
    return out


def stage_totals(tracer: Tracer | None = None) -> dict[tuple[str, str], dict]:
    """(cat, name) -> {count, seconds} over every recorded span."""
    tr = tracer if tracer is not None else get_tracer()
    out: dict[tuple[str, str], dict] = {}
    for rec in tr.records():
        if rec.ph != "X":
            continue
        agg = out.setdefault((rec.cat, rec.name), {"count": 0, "seconds": 0.0})
        agg["count"] += 1
        agg["seconds"] += rec.dur
    return out
