"""MLego observability layer: tracing and metrics (stdlib only).

* ``repro_torch.obs.trace`` — `Span`/`Tracer` with a thread-safe ring
  buffer and Chrome-trace-event export (loads in Perfetto).
* ``repro_torch.obs.metrics`` — `MetricsRegistry` of labelled
  counters/gauges/histograms.
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
