"""Metrics registry: counters, gauges, fixed-bucket histograms.

A copy of ``repro.obs.metrics`` (stdlib only), so the port imports nothing
of ``repro``.

The aggregate half of the telemetry layer (spans are the timeline half):
cheap thread-safe scalar instruments the trainer, ``GraphClient``, and
retrieval paths update on their hot paths *only when telemetry is enabled*
— disabled call sites hold ``None`` and pay one ``is None`` test.

Histograms use **fixed** bucket boundaries chosen at construction (the
default is a 1-2-5 ladder from 1 µs to 50 s in nanoseconds), so ``observe``
is a bisect + one counter increment — no per-sample allocation, no
unbounded reservoir. Percentiles interpolate linearly inside the selected
bucket (values below the first boundary interpolate from 0; the overflow
bucket reports its lower edge), which is the standard fixed-bucket estimate:
deterministic, bounded error of one bucket width, and pinned exactly by
``tests/test_obs.py`` (and ``tests/test_torch_obs.py`` holds this
copy to it).
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

# 1-2-5 ladder, 1 µs .. 50 s, in nanoseconds: round-latency scales from a
# hybrid local round (~10 µs) to a pickle-fallback mp round (~100 ms) all
# land mid-ladder with <= one-bucket relative error.
DEFAULT_NS_BUCKETS: Tuple[int, ...] = tuple(
    m * 10 ** e for e in range(3, 11) for m in (1, 2, 5)
)


class Counter:
    """Monotonic event counter."""

    __slots__ = ("name", "_lock", "_n")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._n = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._n


class Gauge:
    """Last-value instrument; also tracks the high-water mark."""

    __slots__ = ("name", "_lock", "_value", "_max", "_set")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0
        self._max = 0.0
        self._set = False

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)
            self._max = self._value if not self._set else max(self._max, self._value)
            self._set = True

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    @property
    def max(self) -> float:
        with self._lock:
            return self._max


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    Bucket ``i`` covers ``(bounds[i-1], bounds[i]]`` (bucket 0 starts at 0);
    one extra overflow bucket catches values above the last boundary.
    """

    __slots__ = ("name", "bounds", "_lock", "_counts", "_sum")

    def __init__(self, name: str, buckets: Sequence[float] = DEFAULT_NS_BUCKETS):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError("histogram buckets must be non-empty and ascending")
        self.name = name
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in buckets)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, p: float) -> float:
        """Interpolated percentile estimate (``p`` in [0, 100])."""
        with self._lock:
            counts = list(self._counts)
        total = sum(counts)
        if total == 0:
            return 0.0
        rank = (p / 100.0) * total
        cum = 0
        for i, c in enumerate(counts):
            if c and cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else lo
                if hi <= lo:  # overflow bucket: report its lower edge
                    return lo
                return lo + (max(rank - cum, 0.0) / c) * (hi - lo)
            cum += c
        return self.bounds[-1]

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum": round(self.sum, 3),
            "p50": round(self.percentile(50.0), 3),
            "p99": round(self.percentile(99.0), 3),
        }


class MetricsRegistry:
    """Name-keyed get-or-create registry for the three instrument kinds."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            got = self._counters.get(name)
            if got is None:
                got = self._counters[name] = Counter(name)
            return got

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            got = self._gauges.get(name)
            if got is None:
                got = self._gauges[name] = Gauge(name)
            return got

    def histogram(
        self, name: str, buckets: Sequence[float] = DEFAULT_NS_BUCKETS
    ) -> Histogram:
        with self._lock:
            got = self._histograms.get(name)
            if got is None:
                got = self._histograms[name] = Histogram(name, buckets)
            return got

    def summary(self) -> Dict[str, Dict]:
        """JSON-ready snapshot of every registered instrument."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {n: c.value for n, c in sorted(counters.items())},
            "gauges": {
                n: {"value": g.value, "max": g.max}
                for n, g in sorted(gauges.items())
            },
            "histograms": {
                n: h.summary() for n, h in sorted(histograms.items())
            },
        }
