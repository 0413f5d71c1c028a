"""Per-step time attribution for the training loop: the counterpart of
``repro.train.attribution``.

A sync-free phase timer the trainer threads through its loop
(``TrainerConfig(attribution=True)`` fills ``TrainResult.attribution``),
with ``repro``'s phases and ``summary()`` keys:

- ``sample``   — walker and ego sampling rounds (host pipeline, producer side)
- ``assemble`` — TrainBatch -> host numpy batch (dedup, remap, padding)
- ``batch_wait`` — consumer blocked on the prefetch queue (starvation), or
  inline sampling and assembly on the serial path
- ``h2d``      — the stager's pinned copy and ``.to(device, non_blocking=True)``
- ``dispatch`` — the step's host time: PyTorch enqueues its kernels
- ``loss_fetch`` — resolving a window of losses read back asynchronously

Durations land in ``obs.trace.DurationRing`` buffers (no allocation, no
lock, no device sync per step), and with a ``tracer`` every phase interval
is also a span on the exported timeline.

Two readings the port adds beside ``repro``'s keys:

- ``thread_cpu_s``: each phase's CPU time on its own thread
  (``time.thread_time_ns``). Wall minus CPU is time the thread could not
  run: in a phase of Python and PyTorch calls that is mostly the wait for
  the interpreter lock, which the prefetch producer and the step's
  dispatch share.
- ``device_span``: on a CUDA device, one event pair recorded on the current
  stream around each step (``device_span()``), read after the window's final
  barrier. The gap between a pair is the step's **span on the device
  timeline**, from its first queued op to its last. In a dispatch-bound step
  the card waits on the host inside that span, so it is not device busy
  time; the busy share comes from a profiler.

``measure_handoff_overhead`` is copied for parity: the port's plan measures
the wall of pipelined host steps instead (ROADMAP C5).
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.device import DeviceLike
from repro_torch.obs.trace import DurationRing, Tracer

PHASES = ("sample", "assemble", "batch_wait", "h2d", "dispatch", "loss_fetch")
CONSUMER = ("batch_wait", "h2d", "dispatch", "loss_fetch")


def _ms_stats(xs: List[float]) -> Dict[str, float]:
    s = sorted(xs)
    return {"mean_ms": round(sum(s) / len(s), 6), "median_ms": round(median(s), 6),
            "min_ms": round(s[0], 6), "max_ms": round(s[-1], 6)}


class PhaseTimer:
    """Ring-buffered wall-clock attribution of trainer-loop phases.

    ``with timer.phase("dispatch"): ...`` appends one duration (and the
    thread's CPU time over it) to the phase's ring buffers; past
    ``capacity`` the retained window is extrapolated by count in
    :meth:`summary`. ``pulse`` (``HealthMonitor.pulse``) fires at every
    phase exit. ``device``: where the steps run; on CUDA,
    :meth:`device_span` records its event pairs.
    """

    def __init__(self, capacity: int = 8192, tracer: Optional[Tracer] = None,
                 pulse=None, device: DeviceLike = "cpu"):
        self._cap = int(capacity)
        self._dur: Dict[str, DurationRing] = {p: DurationRing(self._cap) for p in PHASES}
        self._cpu: Dict[str, DurationRing] = {p: DurationRing(self._cap) for p in PHASES}
        self._tracer = tracer
        self._pulse = pulse
        self._cuda = torch.device(device).type == "cuda"
        self._events: List[Optional[Tuple]] = [None] * self._cap if self._cuda else []
        self._n_events = 0

    def add(self, name: str, seconds: float) -> None:
        self._dur[name].add(seconds)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter_ns()
        c0 = time.thread_time_ns()
        try:
            yield
        finally:
            cpu_ns = time.thread_time_ns() - c0
            dur_ns = time.perf_counter_ns() - t0
            self._dur[name].add(dur_ns * 1e-9)
            self._cpu[name].add(cpu_ns * 1e-9)
            if self._tracer is not None:
                self._tracer.add_span(name, "phase", t0, dur_ns)
            if self._pulse is not None:
                self._pulse()

    @contextlib.contextmanager
    def device_span(self):
        """A CUDA event pair on the current stream around one step (no sync;
        a no-op off CUDA)."""
        if not self._cuda:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
            self._events[self._n_events % self._cap] = (start, stop)
            self._n_events += 1

    def total(self, name: str) -> float:
        """Total seconds attributed to ``name`` (ring window extrapolated)."""
        return self._dur[name].total()

    def _device_span_summary(self) -> Dict:
        """Read the event pairs; every recorded event must have completed
        (the caller's barrier), or ``elapsed_time`` raises."""
        n = self._n_events
        kept = min(n, self._cap)
        i = n % self._cap if n > self._cap else 0
        pairs = self._events[i:kept] + self._events[:i]
        spans = [a.elapsed_time(b) for a, b in pairs]
        gaps = [b.elapsed_time(a2) for (_, b), (a2, _) in zip(pairs, pairs[1:])]
        out = {"count": n, "total_s": round(sum(spans) / 1e3 * (n / kept), 6),
               "span_ms": _ms_stats(spans),
               "what": "each step's span on the device timeline (CUDA events around "
                       "the step on the current stream); a dispatch-bound step's "
                       "span holds the card's waits on the host, so it is not busy "
                       "time"}
        if gaps:
            out["gap_to_next_step_ms"] = _ms_stats(gaps)
        return out

    def summary(self, wall_s: Optional[float] = None, steps: Optional[int] = None) -> Dict:
        """Per-phase totals and means, consumer-side accounting against wall
        time (``repro``'s keys), then ``thread_cpu_s`` and, on CUDA,
        ``device_span``.

        ``host_visible_s`` sums the phases on the consumer thread, which
        extend the step loop directly; ``device_residual_s`` is the rest of
        the wall: device time the host waited for, and whatever is not
        instrumented. Producer phases overlap the consumer's when
        prefetching, so their fractions may sum past the wall.
        """
        phases: Dict[str, Dict] = {}
        for p in PHASES:
            n = self._dur[p].count
            if n == 0:
                continue
            tot = self.total(p)
            entry = {"count": n, "total_s": round(tot, 6),
                     "per_call_us": round(tot / n * 1e6, 2)}
            if wall_s:
                entry["frac_of_wall"] = round(tot / wall_s, 4)
            phases[p] = entry
        out: Dict = {"phases": phases}
        if wall_s is not None:
            out["wall_s"] = round(wall_s, 6)
            host_vis = sum(self.total(p) for p in CONSUMER if self._dur[p].count)
            out["host_visible_s"] = round(host_vis, 6)
            out["device_residual_s"] = round(max(0.0, wall_s - host_vis), 6)
        if steps:
            out["steps"] = int(steps)
            if wall_s is not None:
                out["wall_us_per_step"] = round(wall_s / steps * 1e6, 2)
        out["thread_cpu_s"] = {p: round(self._cpu[p].total(), 6)
                               for p in PHASES if self._cpu[p].count}
        if self._n_events:
            out["device_span"] = self._device_span_summary()
        return out


def phase_scope(timer: Optional[PhaseTimer], name: Optional[str]):
    """``timer.phase(name)`` when attribution is wired, else a no-op
    context — call sites thread one optional timer without branching."""
    if timer is None or name is None:
        return contextlib.nullcontext()
    return timer.phase(name)


def device_span_scope(timer: Optional[PhaseTimer]):
    """``timer.device_span()`` when attribution is wired, else a no-op."""
    if timer is None:
        return contextlib.nullcontext()
    return timer.device_span()


def measure_handoff_overhead(items: int = 512, depth: int = 2) -> float:
    """Measured per-item cost (seconds) of the prefetch queue handoff: a
    producer thread pushes ``items`` tokens through a bounded
    ``queue.Queue`` (the structure ``_Prefetcher`` uses) while the caller
    consumes them; returns wall / items."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    token = object()

    def produce() -> None:
        for _ in range(items):
            q.put(token)

    t = threading.Thread(target=produce, name="repro-torch-handoff-probe", daemon=True)
    t0 = time.perf_counter()
    t.start()
    for _ in range(items):
        q.get()
    wall = time.perf_counter() - t0
    t.join()
    return wall / items


def median(xs: Iterable[float]) -> float:
    """Median of a small sample."""
    s = sorted(xs)
    if not s:
        raise ValueError("median of empty sample")
    mid = len(s) // 2
    if len(s) % 2:
        return s[mid]
    return 0.5 * (s[mid - 1] + s[mid])
