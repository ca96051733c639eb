"""Bounded metrics: counters, gauges, histograms with fixed bucket layouts.

Same discipline as the span rings: nothing here can grow without bound. The
registry caps the number of metrics, every metric caps its label-set count
(new label combinations beyond the cap fold into one ``overflow`` series and
the fold is counted), and histograms use *fixed* bucket layouts declared at
construction — per-rank metric memory is O(metrics x series x buckets), all
three capped, independent of rank count and run length.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Any

__all__ = [
    "SECONDS_BUCKETS",
    "BYTES_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
]

# fixed layouts (upper bounds; one implicit +inf bucket at the end):
# latencies from 1us to 10s, decades
SECONDS_BUCKETS: tuple[float, ...] = tuple(10.0 ** e for e in range(-6, 2))
# message/transfer sizes from 64B to 1GiB, x4 steps
BYTES_BUCKETS: tuple[float, ...] = tuple(float(4 ** e) for e in range(3, 16))

_OVERFLOW_KEY = (("overflow", "true"),)


def _label_key(labels: dict[str, Any]) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _series_name(key: tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in key) if key else "_total"


class _Bounded:
    """Shared label-set bounding: at most ``max_series`` label combinations
    per metric; later combinations fold into the overflow series."""

    def __init__(self, name: str, max_series: int) -> None:
        self.name = name
        self.max_series = max_series
        self.overflowed = 0  # observations folded into the overflow series

    def _key(self, labels: dict, existing: dict) -> tuple:
        key = _label_key(labels)
        if key in existing or len(existing) < self.max_series:
            return key
        self.overflowed += 1
        return _OVERFLOW_KEY


class Counter(_Bounded):
    """Monotonic per-label-set totals (bytes, messages, compiles)."""

    def __init__(self, name: str, max_series: int = 64) -> None:
        super().__init__(name, max_series)
        self._values: dict[tuple, float] = {}

    def inc(self, value: float = 1, **labels: Any) -> None:
        key = self._key(labels, self._values)
        self._values[key] = self._values.get(key, 0) + value

    def total(self) -> float:
        return sum(self._values.values())

    def series(self) -> dict[str, float]:
        return {_series_name(k): v for k, v in sorted(self._values.items())}

    def snapshot(self) -> dict:
        return {
            "type": "counter",
            "total": self.total(),
            "series": self.series(),
            "overflowed": self.overflowed,
        }


class Gauge(_Bounded):
    """Last-written value per label set (queue depths, cache sizes)."""

    def __init__(self, name: str, max_series: int = 64) -> None:
        super().__init__(name, max_series)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels: Any) -> None:
        key = self._key(labels, self._values)
        self._values[key] = value

    def series(self) -> dict[str, float]:
        return {_series_name(k): v for k, v in sorted(self._values.items())}

    def snapshot(self) -> dict:
        return {
            "type": "gauge",
            "series": self.series(),
            "overflowed": self.overflowed,
        }


class Histogram(_Bounded):
    """Fixed-bucket distribution (latencies, message sizes).

    ``buckets`` are upper bounds; an observation lands in the first bucket
    whose bound is >= the value, or the implicit +inf bucket. The layout is
    fixed at construction — two histograms with the same layout are directly
    comparable across runs and ranks.
    """

    def __init__(self, name: str, buckets: tuple[float, ...] = SECONDS_BUCKETS,
                 max_series: int = 64) -> None:
        super().__init__(name, max_series)
        assert tuple(buckets) == tuple(sorted(buckets)), "buckets must ascend"
        self.buckets = tuple(float(b) for b in buckets)
        # label key -> [counts per bucket + inf, sum, n]
        self._series: dict[tuple, list] = {}

    def observe(self, value: float, **labels: Any) -> None:
        key = self._key(labels, self._series)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = [[0] * (len(self.buckets) + 1), 0.0, 0]
        counts = s[0]
        # first bucket whose bound is >= value; past-the-end = +inf bucket
        counts[bisect_left(self.buckets, value)] += 1
        s[1] += value
        s[2] += 1

    def series(self) -> dict[str, dict]:
        out = {}
        for key, (counts, total, n) in sorted(self._series.items()):
            out[_series_name(key)] = {
                "counts": list(counts),
                "sum": total,
                "n": n,
            }
        return out

    def snapshot(self) -> dict:
        return {
            "type": "histogram",
            "buckets": list(self.buckets),
            "series": self.series(),
            "overflowed": self.overflowed,
        }


class _NullMetric:
    """Returned once the registry is full: observations are dropped (and the
    drop counted by the registry), never unbounded."""

    def inc(self, value: float = 1, **labels: Any) -> None:
        pass

    def set(self, value: float, **labels: Any) -> None:
        pass

    def observe(self, value: float, **labels: Any) -> None:
        pass


_NULL_METRIC = _NullMetric()


class MetricsRegistry:
    """Bounded name -> metric map with get-or-create accessors."""

    def __init__(self, *, max_metrics: int = 256, max_series: int = 64) -> None:
        self.max_metrics = max_metrics
        self.max_series = max_series
        self._metrics: dict[str, Any] = {}
        self.dropped_metrics = 0

    def __len__(self) -> int:
        return len(self._metrics)

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is not None:
            assert isinstance(m, cls), (name, type(m), cls)
            return m
        if len(self._metrics) >= self.max_metrics:
            self.dropped_metrics += 1
            return _NULL_METRIC
        m = self._metrics[name] = cls(name, max_series=self.max_series, **kw)
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: tuple[float, ...] = SECONDS_BUCKETS) -> Histogram:
        return self._get(name, Histogram, buckets=buckets)

    def snapshot(self) -> dict:
        return {
            name: m.snapshot() for name, m in sorted(self._metrics.items())
        }

    def reset(self) -> None:
        self._metrics = {}
        self.dropped_metrics = 0
