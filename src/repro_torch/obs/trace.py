"""Ring-buffered cross-process span tracing: a copy of ``repro.obs.trace``.

Stdlib and numpy only; the port keeps its own copy so it imports nothing
of ``repro``.

A ``Tracer`` records *spans* — ``(name, category, start_ns, duration_ns,
args)`` tuples on the ``time.perf_counter_ns`` clock — into fixed-capacity
per-thread ring buffers. The design constraints mirror
``train/attribution.py``'s (they now share this layer):

- **Sync-free, allocation-bounded hot path.** Each recording thread owns
  one preallocated ring; an append is two list/int operations with no lock
  (single writer per ring — the tracer lock is taken only once per thread,
  at ring creation). Memory is bounded by ``capacity`` spans per thread;
  overflow overwrites the oldest spans and is reported as a drop count,
  never an allocation.
- **Zero-cost when disabled.** Disabled telemetry is the *absence* of a
  tracer (``telemetry=None`` everywhere); instrumented call sites thread
  one optional object and pay a single ``is None`` test. ``span_scope``
  returns a shared ``nullcontext`` for that case.
- **Monotonic clocks only.** Spans are timestamped with
  ``perf_counter_ns`` — never ``time.time()``, which NTP can step
  mid-interval (lint rule O001 enforces this across the instrumented
  modules).

Cross-process spans (the port's graph service, ``repro_torch.graph.service``):
graph-service workers record their serve loop into a
plain local ring (worker.py — no obs import, workers stay numpy-only) and
ship the tuples back piggybacked on the ``stats`` control round. The client
feeds them to :meth:`Tracer.ingest` with a clock offset estimated from the
round-trip midpoint (``offset = worker_clock - (t0 + t1) / 2``), correcting
each worker's ``perf_counter_ns`` epoch into the client's timebase so the
exported timeline lines up across processes. Spans carry the request ``rid``
in ``args``, which is what correlates a worker serve span with the client
round that issued it.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# (name, category, start_ns, duration_ns, args-or-None)
Span = Tuple[str, str, int, int, Optional[Dict]]


class DurationRing:
    """Fixed-capacity ring of float durations with count-extrapolated totals.

    The storage primitive behind ``PhaseTimer``: long runs stay O(capacity)
    memory, and :meth:`total` scales the retained window back up by the true
    count so totals remain unbiased estimates.
    """

    __slots__ = ("_cap", "_buf", "_n")

    def __init__(self, capacity: int):
        self._cap = int(capacity)
        self._buf = np.zeros(self._cap, np.float64)
        self._n = 0

    def add(self, value: float) -> None:
        self._buf[self._n % self._cap] = value
        self._n += 1

    @property
    def count(self) -> int:
        return self._n

    def total(self) -> float:
        """Sum of all recorded values (ring window extrapolated by count)."""
        if self._n == 0:
            return 0.0
        kept = min(self._n, self._cap)
        return float(self._buf[:kept].sum()) * (self._n / kept)


class _SpanRing:
    """One thread's bounded span buffer (single writer, lock-free append)."""

    __slots__ = ("cap", "buf", "n", "thread_name")

    def __init__(self, cap: int, thread_name: str):
        self.cap = cap
        self.buf: List[Optional[Span]] = [None] * cap
        self.n = 0
        self.thread_name = thread_name

    def add(self, span: Span) -> None:
        self.buf[self.n % self.cap] = span
        self.n += 1

    def snapshot(self) -> List[Span]:
        """Retained spans, oldest first."""
        if self.n <= self.cap:
            return [s for s in self.buf[: self.n]]
        i = self.n % self.cap
        return [s for s in self.buf[i:] + self.buf[:i]]

    @property
    def dropped(self) -> int:
        return max(0, self.n - self.cap)


class Tracer:
    """Thread-safe span recorder with per-thread rings and foreign ingest."""

    def __init__(self, capacity: int = 16384, process_name: str = "trainer"):
        self.capacity = int(capacity)
        self.process_name = process_name
        self.pid = os.getpid()
        self._lock = threading.Lock()  # ring registry + foreign ingest only
        self._local = threading.local()
        self._rings: List[_SpanRing] = []
        # ingested remote spans: (process label, pid, spans, dropped count)
        self._foreign: List[Tuple[str, int, List[Span], int]] = []
        # instant marks (rare, warning-path events); bounded, locked
        self._marks: List[Tuple[str, str, int, Optional[Dict]]] = []
        self._marks_cap = 1024

    def _ring(self) -> _SpanRing:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = _SpanRing(self.capacity, threading.current_thread().name)
            with self._lock:
                self._rings.append(ring)
            self._local.ring = ring
        return ring

    def add_span(
        self,
        name: str,
        cat: str,
        start_ns: int,
        dur_ns: int,
        args: Optional[Dict] = None,
    ) -> None:
        """Record one completed span (timestamps on ``perf_counter_ns``)."""
        self._ring().add((name, cat, start_ns, dur_ns, args))

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "trainer", **args):
        """``with tracer.span("client.wait", rid=7): ...``"""
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self._ring().add(
                (name, cat, t0, time.perf_counter_ns() - t0, args or None)
            )

    def mark(self, name: str, cat: str = "mark", **args) -> None:
        """Record an instant event — a degraded-mode flag on the timeline.

        Marks are for rare warning-path conditions (wedged prefetch
        producer, fused fallback, degraded worker): they take the tracer
        lock and are capacity-bounded, so they must never sit on a
        per-step path — that is what spans and counters are for.
        """
        t0 = time.perf_counter_ns()
        with self._lock:
            if len(self._marks) < self._marks_cap:
                self._marks.append((name, cat, t0, args or None))

    def marks(self) -> List[Tuple[str, str, int, Optional[Dict]]]:
        with self._lock:
            return list(self._marks)

    def ingest(
        self,
        process_name: str,
        pid: int,
        spans: Sequence[Span],
        offset_ns: int = 0,
        dropped: int = 0,
    ) -> None:
        """Adopt spans recorded in another process.

        ``offset_ns`` maps the remote ``perf_counter_ns`` epoch into this
        process's: callers estimate it from a control round-trip midpoint
        (``remote_clock - (t_send + t_recv) / 2``), so a remote timestamp
        ``t`` lands at ``t - offset_ns`` on the local timeline.
        """
        corrected = [
            (name, cat, int(t0 - offset_ns), dur, args)
            for name, cat, t0, dur, args in spans
        ]
        with self._lock:
            self._foreign.append((process_name, int(pid), corrected, dropped))

    # --------------------------------------------------------------- readers
    def threads(self) -> List[Tuple[int, str, List[Span], int]]:
        """Per-thread (tid, thread name, spans, dropped) snapshots."""
        with self._lock:
            rings = list(self._rings)
        return [
            (tid, r.thread_name, r.snapshot(), r.dropped)
            for tid, r in enumerate(rings, start=1)
        ]

    def foreign(self) -> List[Tuple[str, int, List[Span], int]]:
        with self._lock:
            return list(self._foreign)

    def span_count(self) -> int:
        """Retained spans across local rings and ingested processes."""
        return sum(len(s) for _, _, s, _ in self.threads()) + sum(
            len(s) for _, _, s, _ in self.foreign()
        )

    def dropped_count(self) -> int:
        return sum(d for _, _, _, d in self.threads()) + sum(
            d for _, _, _, d in self.foreign()
        )


_NULL = contextlib.nullcontext()


def span_scope(tracer: Optional[Tracer], name: str, cat: str = "trainer", **args):
    """``tracer.span(...)`` when tracing is wired, else a shared no-op
    context — call sites thread one optional tracer without branching."""
    if tracer is None:
        return _NULL
    return tracer.span(name, cat=cat, **args)
