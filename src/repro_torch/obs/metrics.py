"""Metrics registry: counters/gauges/histograms with Prometheus export.

The serve stack accumulated three generations of one-off telemetry —
``BackendStats`` monotonic counters, scalar ints on ``MLegoService``
guarded by its stats lock, and the ``LatencyTracker`` percentile ring.
This module replaces the scalar generation outright and gives the
other two a single read surface: a `MetricsRegistry` of typed,
labelled metrics that renders both Prometheus text exposition
(`MetricsRegistry.exposition()`) and a JSON-able snapshot
(`MetricsRegistry.snapshot()`).

Two integration styles, chosen per counter:

* **Native** — the metric object *is* the counter.  Everything that
  used to be a bare int on the service (queries, sheds, degradations,
  evictions) increments a registry `Counter` and the service report
  reads the same object back, so exposition and report cannot drift.
* **Mirrored** — structures with their own locking discipline
  (``BackendStats``, breaker snapshots, the retry ledger) stay the
  writers; a collection callback registered via
  `MetricsRegistry.add_callback()` copies them into gauges/counters at
  scrape time.  Both the report and the scrape read the same live
  source, so they agree whenever no traffic lands in between.

`Histogram` doubles as the SLO feed: with ``window > 0`` each label
set also keeps a bounded deque of recent raw samples, and
`HistogramView` exposes the sliding-window ``p50/p95/p99`` /
``len()`` surface ``SLOPolicy.level()`` expects — the cumulative
buckets serve exposition, the window serves control decisions, one
``observe()`` feeds both.

Naming convention (see api/README.md): ``mlego_<subsystem>_<what>``
with Prometheus unit/suffix rules — ``_total`` for counters,
``_seconds`` / ``_bytes`` base units, label keys for the axis that
varies (``backend``, ``site``, ``level``).

Stdlib only; safe to import from anywhere in ``repro``.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "HistogramView",
    "MetricsRegistry",
]

DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_LabelKey = Tuple[str, ...]


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integral floats drop the mantissa."""
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(names: Tuple[str, ...], values: _LabelKey) -> str:
    if not names:
        return ""
    pairs = ",".join('%s="%s"' % (n, str(v).replace("\\", "\\\\")
                                  .replace('"', '\\"').replace("\n", "\\n"))
                     for n, v in zip(names, values))
    return "{%s}" % pairs


class _Metric:
    """Base: a named family of samples keyed by label values."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, Any]) -> _LabelKey:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                "metric %r takes labels %r, got %r"
                % (self.name, self.labelnames, tuple(labels)))
        return tuple(str(labels[n]) for n in self.labelnames)


class Counter(_Metric):
    """Monotonically increasing value per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = ()):
        super().__init__(name, help, labelnames)
        self._vals: Dict[_LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        k = self._key(labels)
        with self._lock:
            self._vals[k] = self._vals.get(k, 0.0) + amount

    def set_floor(self, value: float, **labels: Any) -> None:
        """Raise the counter to ``value`` if below (mirror-sync helper).

        Used by scrape callbacks that copy an external monotonic
        counter in; never lowers, so the series stays monotone even if
        two mirrors race.
        """
        k = self._key(labels)
        with self._lock:
            if value > self._vals.get(k, 0.0):
                self._vals[k] = float(value)

    def value(self, **labels: Any) -> float:
        k = self._key(labels)
        with self._lock:
            return self._vals.get(k, 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._vals.values())

    def series(self) -> Dict[_LabelKey, float]:
        with self._lock:
            return dict(self._vals)


class Gauge(_Metric):
    """Point-in-time value per label set."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = ()):
        super().__init__(name, help, labelnames)
        self._vals: Dict[_LabelKey, float] = {}

    def set(self, value: float, **labels: Any) -> None:
        k = self._key(labels)
        with self._lock:
            self._vals[k] = float(value)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        k = self._key(labels)
        with self._lock:
            self._vals[k] = self._vals.get(k, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: Any) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: Any) -> float:
        k = self._key(labels)
        with self._lock:
            return self._vals.get(k, 0.0)

    def series(self) -> Dict[_LabelKey, float]:
        with self._lock:
            return dict(self._vals)


class _HistSeries:
    __slots__ = ("counts", "total", "count", "window")

    def __init__(self, n_buckets: int, window: int):
        self.counts = [0] * n_buckets
        self.total = 0.0
        self.count = 0
        self.window: Optional[deque] = deque(maxlen=window) if window else None


class Histogram(_Metric):
    """Cumulative-bucket histogram, optionally with a sample window.

    ``buckets`` are upper bounds (``+Inf`` appended implicitly).  With
    ``window > 0`` every label set also keeps the last ``window`` raw
    observations for exact sliding percentiles — that is what the SLO
    loop reads, while exposition always renders the cumulative buckets.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Tuple[str, ...] = (),
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                 window: int = 0):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("need at least one bucket bound")
        self.buckets = bs
        self.window = int(window)
        self._series: Dict[_LabelKey, _HistSeries] = {}

    def _at(self, k: _LabelKey) -> _HistSeries:
        s = self._series.get(k)
        if s is None:
            s = self._series[k] = _HistSeries(len(self.buckets), self.window)
        return s

    def observe(self, value: float, **labels: Any) -> None:
        k = self._key(labels)
        v = float(value)
        with self._lock:
            s = self._at(k)
            for i, ub in enumerate(self.buckets):
                if v <= ub:
                    s.counts[i] += 1
                    break
            s.total += v
            s.count += 1
            if s.window is not None:
                s.window.append(v)

    def count(self, **labels: Any) -> int:
        k = self._key(labels)
        with self._lock:
            s = self._series.get(k)
            return s.count if s else 0

    def sum(self, **labels: Any) -> float:
        k = self._key(labels)
        with self._lock:
            s = self._series.get(k)
            return s.total if s else 0.0

    def window_samples(self, **labels: Any) -> List[float]:
        k = self._key(labels)
        with self._lock:
            s = self._series.get(k)
            return list(s.window) if s and s.window is not None else []

    def percentile(self, p: float, **labels: Any) -> float:
        """Sliding-window nearest-rank percentile (0 with no samples).

        Matches ``LatencyTracker.percentile`` semantics so the SLO
        policy sees identical numbers after the migration.  Requires
        ``window > 0``; cumulative buckets are not interpolated — a
        control loop should not act on bucket-resolution estimates.
        """
        xs = sorted(self.window_samples(**labels))
        if not xs:
            return 0.0
        rank = max(1, math.ceil(p / 100.0 * len(xs)))
        return xs[min(rank, len(xs)) - 1]

    def view(self, **labels: Any) -> "HistogramView":
        return HistogramView(self, dict(labels))

    def series(self) -> Dict[_LabelKey, Tuple[List[int], float, int]]:
        with self._lock:
            return {k: (list(s.counts), s.total, s.count)
                    for k, s in self._series.items()}


class HistogramView:
    """One label set of a `Histogram`, shaped like ``LatencyTracker``.

    Implements ``observe`` / ``percentile`` / ``p50``/``p95``/``p99`` /
    ``len()`` over the histogram's sliding window so it can be handed
    to ``SLOPolicy.level()`` (which duck-types on ``len`` and ``p95``)
    and to ``BackendSLO`` unchanged.
    """

    __slots__ = ("_hist", "_labels")

    def __init__(self, hist: Histogram, labels: Dict[str, Any]):
        self._hist = hist
        self._labels = labels

    def observe(self, value: float) -> None:
        self._hist.observe(value, **self._labels)

    def percentile(self, p: float) -> float:
        return self._hist.percentile(p, **self._labels)

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p95(self) -> float:
        return self.percentile(95.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    def __len__(self) -> int:
        return len(self._hist.window_samples(**self._labels))


class MetricsRegistry:
    """Get-or-create factory plus exposition for a set of metrics.

    ``counter()``/``gauge()``/``histogram()`` are idempotent: a second
    call with the same name returns the existing object (and raises if
    the type or label names disagree — one name, one meaning).
    Callbacks registered with `add_callback()` run before every
    `exposition()`/`snapshot()` so mirrored sources are fresh at
    scrape time.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}
        self._callbacks: List[Callable[[], None]] = []
        self._lock = threading.Lock()

    # -- factories -------------------------------------------------------

    def _get_or_make(self, cls, name: str, help: str,
                     labelnames: Iterable[str], **kw: Any) -> Any:
        names = tuple(labelnames)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.labelnames != names:
                    raise ValueError(
                        "metric %r re-registered as %s%r (was %s%r)"
                        % (name, cls.kind, names, m.kind, m.labelnames))
                return m
            m = cls(name, help, names, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                  window: int = 0) -> Histogram:
        return self._get_or_make(Histogram, name, help, labelnames,
                                 buckets=buckets, window=window)

    def add_callback(self, fn: Callable[[], None]) -> None:
        """Register a pre-scrape sync hook (mirroring external counters)."""
        with self._lock:
            self._callbacks.append(fn)

    def collect(self) -> List[_Metric]:
        """Run callbacks, then return metrics sorted by name."""
        with self._lock:
            cbs = list(self._callbacks)
        for cb in cbs:
            cb()
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    # -- output ----------------------------------------------------------

    def exposition(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        for m in self.collect():
            lines.append("# HELP %s %s" % (m.name, m.help or m.name))
            lines.append("# TYPE %s %s" % (m.name, m.kind))
            if isinstance(m, (Counter, Gauge)):
                series = m.series()
                for key in sorted(series):
                    lines.append("%s%s %s" % (m.name,
                                              _label_str(m.labelnames, key),
                                              _fmt(series[key])))
            elif isinstance(m, Histogram):
                for key, (counts, total, count) in sorted(m.series().items()):
                    cum = 0
                    for ub, c in zip(m.buckets, counts):
                        cum += c
                        ls = _label_str(m.labelnames + ("le",),
                                        key + (_fmt(ub),))
                        lines.append("%s_bucket%s %d" % (m.name, ls, cum))
                    ls = _label_str(m.labelnames + ("le",), key + ("+Inf",))
                    lines.append("%s_bucket%s %d" % (m.name, ls, count))
                    ls = _label_str(m.labelnames, key)
                    lines.append("%s_sum%s %s" % (m.name, ls, _fmt(total)))
                    lines.append("%s_count%s %d" % (m.name, ls, count))
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dump: {name: {type, labels, series}}."""
        out: Dict[str, Any] = {}
        for m in self.collect():
            if isinstance(m, (Counter, Gauge)):
                series = {"|".join(k) if k else "": v
                          for k, v in m.series().items()}
            else:
                assert isinstance(m, Histogram)
                series = {"|".join(k) if k else "": {
                    "buckets": counts, "sum": total, "count": count,
                } for k, (counts, total, count) in m.series().items()}
            out[m.name] = {"type": m.kind,
                           "labels": list(m.labelnames),
                           "series": series}
        return out
