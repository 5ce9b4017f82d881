"""SLO feedback — sliding latency percentiles driving plan degradation.

The paper's merge approximation is a quality/latency dial: α trades
plan accuracy (Eq. 2's loss term) against time.  Under overload the
dial should turn itself: the service tracks a sliding window of
client-observed latencies (enqueue → answer) per execution backend,
and when the window's p95 blows past the configured SLO it *degrades*
new queries — first by scaling their α toward the fast end, then by
restricting to plan-cache-only / α=0 plans and pausing speculative
training, so capacity is spent answering queries rather than
polishing them.  The degradation level applied to every answered
query lands on ``QueryReport.degraded`` (0 = full quality).

``LatencyTracker`` is the measurement half: a bounded deque of recent
latencies with percentile reads.  ``SLOPolicy`` is the decision half:
pure (p95, sample count) → level, so tests can pin it without traffic.

``SLOPolicy.level`` duck-types its tracker argument — anything with
``len()`` and ``.p95`` qualifies.  The service now feeds it a
``repro_torch.obs.metrics.HistogramView`` over the shared
``mlego_serve_latency_seconds`` histogram's sliding window (one
``observe()`` feeds both the Prometheus exposition buckets and this
control loop), keeping ``LatencyTracker`` as the standalone
implementation for callers without a registry.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Deque, Tuple


class LatencyTracker:
    """Sliding window of observed latencies (seconds), thread-safe.

    The window is bounded by count, not time: under overload (the only
    regime where the SLO loop matters) samples arrive fast and the
    window spans recent seconds; at idle a stale window merely keeps
    the last known level until fresh traffic updates it.
    """

    def __init__(self, window: int = 256):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._samples: Deque[float] = deque(maxlen=window)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def observe(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(float(seconds))

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile of the current window (0.0 when
        empty — callers gate on ``len`` via the policy's min_samples)."""
        with self._lock:
            if not self._samples:
                return 0.0
            data = sorted(self._samples)
        rank = min(int(p / 100.0 * len(data)), len(data) - 1)
        return data[rank]

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p95(self) -> float:
        return self.percentile(95.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)


@dataclass(frozen=True)
class SLOPolicy:
    """Degradation decision: window p95 vs the target, in levels.

    p95_slo_s    : the latency objective the operator promised
    min_samples  : below this window size the level is always 0 (no
                   degradation off a cold or trivial window)
    degrade_at   : level 1 when p95 > degrade_at × SLO  (α halved)
    heavy_at     : level 2 when p95 > heavy_at × SLO    (α → 0 unless
                   the original-α plan is already cached; speculation
                   paused)
    severe_at    : level 3 when p95 > severe_at × SLO   (as level 2 —
                   reserved headroom for harsher measures; reported
                   distinctly so operators see how deep overload runs)
    """

    p95_slo_s: float
    min_samples: int = 8
    degrade_at: float = 1.0
    heavy_at: float = 2.0
    severe_at: float = 4.0
    # α multiplier per level; beyond the tuple, the last entry applies
    alpha_factors: Tuple[float, ...] = (1.0, 0.5, 0.0, 0.0)
    pause_speculation_at: int = 2

    def __post_init__(self) -> None:
        if self.p95_slo_s <= 0:
            raise ValueError(f"p95_slo_s must be > 0, got {self.p95_slo_s}")
        if not (self.degrade_at <= self.heavy_at <= self.severe_at):
            raise ValueError("degradation thresholds must be ordered: "
                             "degrade_at <= heavy_at <= severe_at")

    def level(self, tracker: LatencyTracker) -> int:
        if len(tracker) < self.min_samples:
            return 0
        ratio = tracker.p95 / self.p95_slo_s
        if ratio > self.severe_at:
            return 3
        if ratio > self.heavy_at:
            return 2
        if ratio > self.degrade_at:
            return 1
        return 0

    def alpha_factor(self, level: int) -> float:
        if level <= 0:
            return 1.0
        idx = min(level, len(self.alpha_factors) - 1)
        return self.alpha_factors[idx]


@dataclass(frozen=True)
class BackendSLO:
    """One backend's latency window, as ``ServiceReport`` snapshots it."""

    p50_s: float = 0.0
    p95_s: float = 0.0
    p99_s: float = 0.0
    samples: int = 0
    level: int = 0


__all__ = ["BackendSLO", "LatencyTracker", "SLOPolicy"]
