"""MLego observability layer: tracing, metrics, kernel profiling.

* ``repro_torch.obs.trace`` — `Span`/`Tracer` with a thread-safe ring
  buffer and Chrome-trace-event export (loads in Perfetto).
* ``repro_torch.obs.metrics`` — `MetricsRegistry` of labelled
  counters/gauges/histograms.
* ``repro_torch.obs.profile`` — opt-in kernel profiling hooks:
  ``torch.profiler`` / NVTX ranges around device launches plus flops and
  bytes counted from the launch's shapes, landed as span attributes.

``trace`` and ``metrics`` are stdlib-only by design; only ``profile``
imports torch, and this package does not import it.
"""
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    HistogramView,
    MetricsRegistry,
)
from repro_torch.obs.trace import (
    Span,
    Tracer,
    current_span,
    current_tracer,
    instant,
    set_attrs,
    span,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "HistogramView",
    "MetricsRegistry",
    "Span",
    "Tracer",
    "current_span",
    "current_tracer",
    "instant",
    "set_attrs",
    "span",
]
