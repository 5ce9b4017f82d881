"""Workload-driven speculative gap pre-training.

The serving layer's query log is a prophecy: interactive exploration
replays hot σ ranges (pan/zoom, re-render, dashboard refresh), and a
hot range whose plan still carries ``TrainGapStep``s pays the gap
training on *every* volatile query.  The ``SpeculativeTrainer`` mines
``MLegoService``'s per-tenant query log for ranges seen at least
``min_count`` times inside ``window_s``, re-plans them against the
current store, and pre-trains the uncovered gap segments **only when
the cost provider forecasts the training lands before the range's next
predicted arrival** (``CostProvider.speculation_pays`` — with a
calibrated provider this is a measured-κ forecast, so speculation
self-throttles to gaps it can actually finish in time).  Trained
segments persist to the shared store and warm-insert into the backend
device cache via ``ExecutionBackend.note_trained``; the next hot query
fetches them instead of training (a *speculative hit*, counted by the
service when an answered plan's model ids intersect the speculated
set).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Set, Tuple

from repro_torch.core.plans import Interval

SPECULATION_TENANT = "__speculator__"


@dataclass(frozen=True)
class QueryLogEntry:
    """One answered query, as the speculator sees it."""

    tenant: str
    sigma: Tuple[Tuple[float, float], ...]   # normalized component bounds
    kind: str
    alpha: float
    backend: Optional[str]
    t: float                                 # monotonic arrival stamp


@dataclass(frozen=True)
class SpeculationReport:
    """Cumulative speculation counters."""

    scans: int = 0
    hot_ranges: int = 0          # (σ, kind, α) groups past min_count
    gaps_considered: int = 0
    trained: int = 0             # gap segments pre-trained
    trained_tokens: int = 0
    skipped_payoff: int = 0      # gaps whose forecast missed the window
    hits: int = 0                # answered queries that fetched
    #                              speculated capital
    paused: bool = False         # SLO loop currently holds speculation
    pauses: int = 0              # times the SLO loop paused it

    @property
    def hit_rate(self) -> float:
        return self.hits / self.trained if self.trained else 0.0


class SpeculativeTrainer:
    """Mines a service's query log; pre-trains hot gaps that pay.

    service   : the owning ``MLegoService`` (query log, sessions,
                shared cost provider and backends)
    window_s  : how far back in the log a range must repeat to be hot
    min_count : arrivals inside the window that make a range hot
    margin    : safety factor on the training-time forecast (> 1 =
                conservative: only speculate with headroom)
    poll_s    : background scan period (``start=False`` skips the
                thread; call ``scan_once`` manually — tests do)
    """

    def __init__(self, service, *, window_s: float = 30.0,
                 min_count: int = 2, margin: float = 1.0,
                 poll_s: float = 0.05, start: bool = True):
        self.service = service
        self.window_s = float(window_s)
        self.min_count = int(min_count)
        self.margin = float(margin)
        self._poll_s = poll_s
        self._lock = threading.Lock()
        self.trained_ids: Set[int] = set()
        self._scans = self._hot = self._considered = 0
        self._trained = self._trained_tokens = self._skipped = 0
        self._hits = 0
        self._paused = False
        self._pauses = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="mlego-speculator", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------
    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self._poll_s):
            try:
                self.scan_once()
            except Exception:
                # a failed scan must never kill speculation (or leak
                # into query threads) — the next scan starts clean
                pass

    # ------------------------------------------------------------------
    def note_hit(self) -> None:
        with self._lock:
            self._hits += 1

    @property
    def paused(self) -> bool:
        return self._paused

    def set_paused(self, paused: bool) -> None:
        """SLO hook: under heavy degradation the service parks the
        speculator so overload capacity answers queries instead of
        pre-training for them; cleared automatically when the latency
        window recovers."""
        with self._lock:
            if paused and not self._paused:
                self._pauses += 1
            self._paused = bool(paused)

    def _hot_groups(self, now: float) -> List[Tuple[Tuple, List[float]]]:
        """(group key, arrival stamps) for ranges hot in the window."""
        groups = {}
        for e in self.service.query_log():
            if now - e.t > self.window_s:
                continue
            groups.setdefault((e.sigma, e.kind, e.alpha, e.backend),
                              []).append(e.t)
        return [(k, sorted(ts)) for k, ts in sorted(groups.items())
                if len(ts) >= self.min_count]

    def scan_once(self) -> int:
        """One mining pass; returns the number of segments trained."""
        if self._paused:
            return 0
        now = time.monotonic()
        hot = self._hot_groups(now)
        with self._lock:
            self._scans += 1
            self._hot += len(hot)
        trained_here = 0
        sess = self.service.session(SPECULATION_TENANT)
        cost = self.service.cost
        for (sigma, kind, alpha, backend_name), ts in hot:
            backend = self.service.backend if backend_name is None \
                else self.service._shared_backend(backend_name)
            # predicted time until the range's next arrival: mean
            # inter-arrival past the last stamp (a single stamp can't
            # be hot — min_count >= 2 guards the division)
            inter = (ts[-1] - ts[0]) / (len(ts) - 1)
            budget = max(ts[-1] + inter - now, 0.0)
            models = sess._models(kind)
            cost.set_train_backend(backend.name)
            for lo, hi in sigma:
                res = sess.planner.plan(models, Interval(lo, hi), alpha)
                for g in res.ir.gaps:
                    if g.n_tokens <= 0:
                        continue
                    with self._lock:
                        self._considered += 1
                    if not cost.speculation_pays(g.n_tokens, budget,
                                                 self.margin):
                        with self._lock:
                            self._skipped += 1
                        continue
                    m = sess.executor.train_gap(
                        g.gap.lo, g.gap.hi, kind, persist=True,
                        backend=backend)
                    if m is None:
                        continue
                    trained_here += 1
                    with self._lock:
                        self.trained_ids.add(m.model_id)
                        self._trained += 1
                        self._trained_tokens += m.n_tokens
        return trained_here

    # ------------------------------------------------------------------
    def report(self) -> SpeculationReport:
        with self._lock:
            return SpeculationReport(
                scans=self._scans, hot_ranges=self._hot,
                gaps_considered=self._considered,
                trained=self._trained,
                trained_tokens=self._trained_tokens,
                skipped_payoff=self._skipped, hits=self._hits,
                paused=self._paused, pauses=self._pauses)


__all__ = ["QueryLogEntry", "SpeculationReport", "SpeculativeTrainer",
           "SPECULATION_TENANT"]
