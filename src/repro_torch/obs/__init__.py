"""repro_torch.obs — telemetry for the port: span tracing, metrics, Perfetto
export, run health and device-memory accounting.

The counterpart of ``repro.obs``, with the same names. ``trace``,
``metrics``, ``export`` and ``health`` are stdlib copies; ``memory`` reads
PyTorch's caching allocator on an explicit device. One :class:`Telemetry`
bundle carries a ring-buffered span :class:`Tracer` and a
:class:`MetricsRegistry`, threaded explicitly — never a global — through
``TrainerConfig.telemetry`` into the trainer loop and the prefetcher,
``evaluate_recall(telemetry=)`` into retrieval, and
``BatchedServer(telemetry=)`` into serving::

    from repro_torch.obs import Telemetry

    tel = Telemetry()
    trainer = Graph4RecTrainer(..., TrainerConfig(..., telemetry=tel))
    trainer.train()
    tel.write_trace("out.trace.json")   # open in https://ui.perfetto.dev
    print(tel.text_summary())

Disabled telemetry is ``telemetry=None`` (the default) everywhere: no rings
are allocated, no events are emitted, and instrumented call sites pay one
``is None`` test.
"""
from repro_torch.obs.export import chrome_trace, text_summary, trace_events, write_trace
from repro_torch.obs.health import (
    HealthConfig,
    HealthMonitor,
    LossAnomalyError,
    RunStalledError,
)
from repro_torch.obs.memory import (
    MemoryAccountant,
    device_memory_stats,
    live_array_bytes,
    memory_snapshot,
)
from repro_torch.obs.metrics import (
    DEFAULT_NS_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.trace import DurationRing, Span, Tracer, span_scope


class Telemetry:
    """One tracer + one metrics registry, wired together for export."""

    def __init__(self, span_capacity: int = 16384, process_name: str = "trainer"):
        self.tracer = Tracer(capacity=span_capacity, process_name=process_name)
        self.metrics = MetricsRegistry()

    def span(self, name: str, cat: str = "trainer", **args):
        return self.tracer.span(name, cat=cat, **args)

    def chrome_trace(self) -> dict:
        return chrome_trace(self.tracer, self.metrics)

    def write_trace(self, path: str) -> str:
        return write_trace(path, self.tracer, self.metrics)

    def text_summary(self) -> str:
        return text_summary(self.tracer, self.metrics)


__all__ = [
    "Counter",
    "DEFAULT_NS_BUCKETS",
    "DurationRing",
    "Gauge",
    "HealthConfig",
    "HealthMonitor",
    "Histogram",
    "LossAnomalyError",
    "MemoryAccountant",
    "MetricsRegistry",
    "RunStalledError",
    "Span",
    "Telemetry",
    "Tracer",
    "chrome_trace",
    "device_memory_stats",
    "live_array_bytes",
    "memory_snapshot",
    "span_scope",
    "text_summary",
    "trace_events",
    "write_trace",
]
