"""Per-rank span tracer with bounded ring buffers and an injectable clock.

The tracer is a process-wide singleton (:func:`get_tracer` /
:func:`configure`) so instrumentation sites can cache the object at import
time — ``configure`` mutates it in place, never replaces it. The repo is
single-threaded by design (simulated ranks run cooperatively on one host
thread), so no locking is needed; span nesting depth is tracked on the
tracer itself.

Records are the paper's bounded-metadata discipline applied to
observability: each simulated rank owns a fixed-capacity ring
(:class:`_Ring`) — a rank's telemetry memory is bounded by ``capacity``
records regardless of rank count or run length, evictions are counted, and
there is no global append-only log anywhere.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from .metrics import MetricsRegistry

__all__ = ["SpanRecord", "Span", "Tracer", "NULL_SPAN", "configure", "get_tracer"]

# nominal bytes per record for the held-bytes bound (name/cat interned refs +
# three floats + small args dict); a sizing convention, not a measurement
RECORD_NOMINAL_BYTES = 160


class SpanRecord:
    """One completed span or instant event (immutable once recorded)."""

    __slots__ = ("name", "cat", "rank", "ph", "t0", "dur", "depth", "args")

    def __init__(self, name, cat, rank, ph, t0, dur, depth, args):
        self.name = name
        self.cat = cat  # subsystem: becomes the trace thread (tid)
        self.rank = rank  # becomes the trace process (pid)
        self.ph = ph  # "X" complete span | "i" instant
        self.t0 = t0
        self.dur = dur
        self.depth = depth
        self.args = args  # dict | None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"SpanRecord({self.name!r}, cat={self.cat!r}, rank={self.rank}, "
            f"ph={self.ph!r}, t0={self.t0:.6f}, dur={self.dur:.6f})"
        )


class _Ring:
    """Fixed-capacity record ring: eviction counted, memory bounded."""

    __slots__ = ("capacity", "_buf", "_next", "evicted", "total")

    def __init__(self, capacity: int) -> None:
        assert capacity > 0, capacity
        self.capacity = capacity
        self._buf: list[SpanRecord] = []
        self._next = 0  # overwrite cursor once the buffer is full
        self.evicted = 0
        self.total = 0

    def __len__(self) -> int:
        return len(self._buf)

    def append(self, rec: SpanRecord) -> None:
        self.total += 1
        if len(self._buf) < self.capacity:
            self._buf.append(rec)
            return
        self._buf[self._next] = rec
        self._next = (self._next + 1) % self.capacity
        self.evicted += 1

    def snapshot(self) -> list[SpanRecord]:
        """Records in chronological (recording) order."""
        return self._buf[self._next :] + self._buf[: self._next]


class _NullSpan:
    """Shared no-op span: the disabled fast path allocates nothing."""

    __slots__ = ()
    seconds = 0.0
    t0 = 0.0

    def set(self, **_kw) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *_exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class Span:
    """A timed region; records into the tracer's ring on exit (if enabled).

    ``seconds`` is valid after ``__exit__`` and is the value the
    instrumentation feeds into ``StageStats`` — by construction, summing the
    recorded spans reproduces the stats surface exactly.
    """

    __slots__ = ("_tracer", "_record", "name", "cat", "rank", "args", "depth",
                 "t0", "seconds")

    def __init__(self, tracer: "Tracer", name: str, cat: str, rank: int,
                 record: bool, args: dict | None) -> None:
        self._tracer = tracer
        self._record = record
        self.name = name
        self.cat = cat
        self.rank = rank
        self.args = args
        self.depth = 0
        self.t0 = 0.0
        self.seconds = 0.0

    def set(self, **kw: Any) -> None:
        """Attach args discovered mid-span (bytes moved, counts, ...)."""
        if self.args is None:
            self.args = kw
        else:
            self.args.update(kw)

    def __enter__(self) -> "Span":
        tr = self._tracer
        self.depth = tr._depth
        tr._depth += 1
        self.t0 = tr.clock()
        return self

    def __exit__(self, *_exc) -> bool:
        tr = self._tracer
        t1 = tr.clock()
        tr._depth -= 1
        self.seconds = t1 - self.t0
        if self._record:
            tr._ring(self.rank).append(
                SpanRecord(self.name, self.cat, self.rank, "X", self.t0,
                           self.seconds, self.depth, self.args)
            )
        return False


class Tracer:
    """Process-wide span tracer + metrics registry.

    Attributes:
        enabled: master switch; when False, :meth:`span` and :meth:`instant`
            are no-ops and :meth:`stage` only times.
        capacity: per-rank ring capacity (records); changing it via
            :meth:`configure` drops existing rings.
        clock: monotonic time source, injectable for deterministic tests.
        metrics: the bounded :class:`~repro.telemetry.metrics.MetricsRegistry`.
    """

    def __init__(self, *, enabled: bool = False, capacity: int = 4096,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        self.enabled = enabled
        self.capacity = capacity
        self.clock = clock
        self.metrics = MetricsRegistry()
        self._rings: dict[int, _Ring] = {}
        self._depth = 0

    # -- configuration ---------------------------------------------------------
    def configure(self, *, enabled: bool | None = None,
                  capacity: int | None = None,
                  clock: Callable[[], float] | None = None) -> "Tracer":
        """Mutate the tracer in place (identity-stable: cached references at
        instrumentation sites keep working). A capacity change resets the
        rings — the bound is a construction property, not a trim."""
        if enabled is not None:
            self.enabled = enabled
        if clock is not None:
            self.clock = clock
        if capacity is not None and capacity != self.capacity:
            self.capacity = capacity
            self._rings = {}
        return self

    def reset(self) -> None:
        """Drop all recorded spans and metrics (keeps configuration)."""
        self._rings = {}
        self.metrics.reset()
        self._depth = 0

    # -- recording -------------------------------------------------------------
    def _ring(self, rank: int) -> _Ring:
        ring = self._rings.get(rank)
        if ring is None:
            ring = self._rings[rank] = _Ring(self.capacity)
        return ring

    def span(self, name: str, *, cat: str = "default", rank: int = 0,
             **args: Any):
        """A recorded span — the pure-observability idiom. Returns the shared
        :data:`NULL_SPAN` when disabled (no allocation, no clock reads)."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, cat, rank, True, args or None)

    def stage(self, name: str, *, cat: str = "stage", rank: int = 0,
              **args: Any) -> Span:
        """A span that *always* times (its ``.seconds`` feeds ``StageStats``)
        but records only when enabled — the drop-in replacement for the
        ``t0 = perf_counter(); ...; StageStats(seconds=...)`` boilerplate."""
        return Span(self, name, cat, rank, self.enabled, args or None)

    def instant(self, name: str, *, cat: str = "default", rank: int = 0,
                **args: Any) -> None:
        """Record a zero-duration event (h2d/d2h transfer, jit trace, job
        lifecycle edge). No-op when disabled."""
        if not self.enabled:
            return
        self._ring(rank).append(
            SpanRecord(name, cat, rank, "i", self.clock(), 0.0, self._depth,
                       args or None)
        )

    # -- introspection ---------------------------------------------------------
    def records(self, rank: int | None = None) -> list[SpanRecord]:
        """Recorded events, chronological; all ranks merged unless ``rank``
        is given."""
        if rank is not None:
            ring = self._rings.get(rank)
            return ring.snapshot() if ring is not None else []
        out: list[SpanRecord] = []
        for r in sorted(self._rings):
            out.extend(self._rings[r].snapshot())
        out.sort(key=lambda rec: rec.t0)
        return out

    def buffer_stats(self) -> dict[int, dict[str, int]]:
        """Per-rank ring accounting: entries, capacity, evicted, total."""
        return {
            r: {
                "entries": len(ring),
                "capacity": ring.capacity,
                "evicted": ring.evicted,
                "total": ring.total,
            }
            for r, ring in sorted(self._rings.items())
        }

    def held_bytes_per_rank(self) -> dict[int, int]:
        """Nominal telemetry bytes held per rank (the Table-1 quantity for
        the observability layer): entries x a fixed per-record size. Bounded
        by ``capacity * RECORD_NOMINAL_BYTES`` for every rank by
        construction."""
        return {
            r: len(ring) * RECORD_NOMINAL_BYTES
            for r, ring in sorted(self._rings.items())
        }


# the process-wide tracer: identity-stable, mutated by configure()
_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer (cacheable at import time)."""
    return _GLOBAL


def configure(**kw) -> Tracer:
    """Configure the process-wide tracer; see :meth:`Tracer.configure`."""
    return _GLOBAL.configure(**kw)
