"""Chrome trace-event JSON export + text summary for the telemetry layer.

A copy of ``repro.obs.export`` (stdlib only), so the port imports nothing
of ``repro``.

``chrome_trace`` renders a :class:`~repro_torch.obs.trace.Tracer` (plus an
optional :class:`~repro_torch.obs.metrics.MetricsRegistry`) as a Chrome
trace-event JSON object — the format Perfetto (https://ui.perfetto.dev)
and ``chrome://tracing`` load directly:

- every span becomes one complete ("X") event with microsecond ``ts`` /
  ``dur`` (span timestamps are ``perf_counter_ns``; the exporter divides by
  1000),
- each recording thread gets its own ``tid`` track inside the tracer's
  process (``pid``), named via "M" (metadata) events,
- spans ingested from other processes (graph-service workers) keep their
  own ``pid`` tracks, so a traced mp run shows the trainer's threads and
  every worker side by side on one clock-corrected timeline, and a worker
  serve span lines up under the client round that issued it (correlate by
  the ``rid`` in ``args``).

``text_summary`` is the terminal rendering: per-track span aggregates plus
the metrics registry snapshot — the quick look before reaching for
Perfetto.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer


def _meta(pid: int, tid: int, name: str, value: str) -> Dict:
    return {
        "ph": "M", "pid": pid, "tid": tid, "ts": 0,
        "name": name, "args": {"name": value},
    }


def trace_events(tracer: Tracer) -> List[Dict]:
    """Flatten a tracer into a Chrome trace-event list."""
    events: List[Dict] = [_meta(tracer.pid, 0, "process_name", tracer.process_name)]
    for tid, thread_name, spans, _dropped in tracer.threads():
        events.append(_meta(tracer.pid, tid, "thread_name", thread_name))
        for name, cat, t0, dur, args in spans:
            ev = {
                "ph": "X", "pid": tracer.pid, "tid": tid, "name": name,
                "cat": cat, "ts": t0 / 1e3, "dur": dur / 1e3,
            }
            if args:
                ev["args"] = args
            events.append(ev)
    # instant ("i") events: warning-path marks, drawn process-wide so a
    # degraded run is visible at any zoom level
    for name, cat, t0, args in tracer.marks():
        ev = {
            "ph": "i", "s": "p", "pid": tracer.pid, "tid": 0,
            "name": name, "cat": cat, "ts": t0 / 1e3,
        }
        if args:
            ev["args"] = args
        events.append(ev)
    for process_name, pid, spans, _dropped in tracer.foreign():
        events.append(_meta(pid, 0, "process_name", process_name))
        events.append(_meta(pid, 1, "thread_name", "serve"))
        for name, cat, t0, dur, args in spans:
            ev = {
                "ph": "X", "pid": pid, "tid": 1, "name": name,
                "cat": cat, "ts": t0 / 1e3, "dur": dur / 1e3,
            }
            if args:
                ev["args"] = args
            events.append(ev)
    return events


def chrome_trace(
    tracer: Tracer, metrics: Optional[MetricsRegistry] = None
) -> Dict:
    """The loadable trace object ({"traceEvents": [...], ...})."""
    out: Dict = {
        "traceEvents": trace_events(tracer),
        "displayTimeUnit": "ms",
    }
    other: Dict = {"dropped_spans": tracer.dropped_count()}
    if metrics is not None:
        other["metrics"] = metrics.summary()
    out["otherData"] = other
    return out


def write_trace(
    path: str, tracer: Tracer, metrics: Optional[MetricsRegistry] = None
) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer, metrics), f, indent=1)
        f.write("\n")
    return path


def text_summary(
    tracer: Tracer, metrics: Optional[MetricsRegistry] = None
) -> str:
    """Terminal rendering: per-track span aggregates + metrics snapshot."""
    lines: List[str] = ["telemetry summary"]
    tracks = [
        (f"{tracer.process_name}/{tname}", spans, dropped)
        for _tid, tname, spans, dropped in tracer.threads()
    ] + [
        (f"{pname}(pid {pid})/serve", spans, dropped)
        for pname, pid, spans, dropped in tracer.foreign()
    ]
    for track, spans, dropped in tracks:
        agg: Dict[str, List[float]] = {}
        for name, _cat, _t0, dur, _args in spans:
            agg.setdefault(name, []).append(dur)
        note = f" (dropped {dropped})" if dropped else ""
        lines.append(f"  [{track}] {len(spans)} spans{note}")
        for name in sorted(agg):
            durs = agg[name]
            tot = sum(durs)
            lines.append(
                f"    {name:<24} x{len(durs):<6} total {tot / 1e6:>10.2f}ms"
                f"  mean {tot / len(durs) / 1e3:>9.1f}us"
            )
    if metrics is not None:
        snap = metrics.summary()
        if snap["counters"]:
            lines.append("  counters:")
            for name, v in snap["counters"].items():
                lines.append(f"    {name:<32} {v}")
        if snap["gauges"]:
            lines.append("  gauges (last/max):")
            for name, g in snap["gauges"].items():
                lines.append(f"    {name:<32} {g['value']:g}/{g['max']:g}")
        if snap["histograms"]:
            lines.append("  histograms (count, p50, p99):")
            for name, h in snap["histograms"].items():
                lines.append(
                    f"    {name:<32} n={h['count']} p50={h['p50'] / 1e6:.3f}ms"
                    f" p99={h['p99'] / 1e6:.3f}ms"
                )
    return "\n".join(lines)
