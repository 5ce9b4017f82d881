"""Query/batch result types returned by ``MLegoSession``.

``QueryReport`` is the single-query answer (Fig. 2 output): the merged
topic matrix plus the per-stage cost breakdown.  ``BatchReport`` is the
§V.C batch answer and fixes the seed repo's cost-attribution bug: the
shared plan-search and gap-training costs live **on the batch report**
(``shared_search_s`` / ``shared_train_s``), not smeared onto the first
query's result, so per-query latency stats stay meaningful.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.api.spec import QuerySpec
from repro_torch.core.batch_opt import BatchResult
from repro_torch.core.lda import MaterializedModel
from repro_torch.core.search import SearchResult


@dataclass
class QueryReport:
    """Answer to one ``QuerySpec``.

    ``plans`` holds one ``SearchResult`` per predicate component (a
    single-interval σ has exactly one).  Inside a batch, ``train_s``
    and ``search_s`` are 0.0 — those costs are shared and reported on
    the ``BatchReport``.

    ``backend`` names the execution backend that answered the query.
    On the device backend, ``merge_device_ms`` is the wall time of the
    fused kernel launch (upload + launch + sync; 0.0 on host),
    ``train_device_ms`` the wall time of kernel-route gap training
    (blocked Gibbs sweep / fused E-step; 0.0 on host or when no gap
    was trained), ``cache_hits``/``cache_misses`` count device-cache
    traffic for this query's parts, and ``cache_resident_bytes``
    gauges the device model cache's residency right after the merge.
    Inside a batch the launch is shared, so the traffic counters live
    on the ``BatchReport`` and stay zero here.

    ``plan_cached`` is True when every component's plan came from the
    session plan cache — the search stage was skipped entirely (and
    ``search_s`` is just the lookup time).

    ``degraded`` is the serving layer's SLO degradation level at
    answer time (0 = full quality; >= 1 means the service scaled the
    spec's effective α down to shed planning/training work under
    overload — see ``repro_torch.serve.slo``).  Always 0 for direct session
    use.

    ``fallback_from`` names the backend the query was *submitted* to
    when device loss forced a replay on the fallback chain
    (``backend`` then names the backend that actually answered);
    None on the healthy path.  The serving layer reads it to feed the
    per-backend circuit breaker.

    ``trace`` is the query's trace id in the session's (or service's)
    ``repro_torch.obs.Tracer`` — look it up with ``tracer.spans(trace_id=
    report.trace)`` or find it in the exported Chrome trace.  None
    when tracing is disabled.
    """

    beta: np.ndarray                 # merged topic-word matrix (K, V)
    spec: QuerySpec
    plans: Tuple[SearchResult, ...]
    n_trained_tokens: int
    n_merged: int
    train_s: float
    merge_s: float
    search_s: float
    materialized: List[MaterializedModel] = field(default_factory=list)
    backend: str = "host"
    merge_device_ms: float = 0.0
    train_device_ms: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0
    cache_resident_bytes: int = 0
    plan_cached: bool = False
    degraded: int = 0
    fallback_from: Optional[str] = None
    trace: Optional[str] = None

    @property
    def plan(self) -> SearchResult:
        """The (first) component plan — the whole plan for interval σ."""
        return self.plans[0]

    @property
    def model_ids(self) -> Tuple[int, ...]:
        return tuple(sorted(m.model_id for p in self.plans for m in p.plan))

    @property
    def n_reused(self) -> int:
        return sum(len(p.plan) for p in self.plans)

    @property
    def total_s(self) -> float:
        return self.train_s + self.merge_s + self.search_s


@dataclass
class BatchReport:
    """Answer to ``submit_many``: per-query reports + batch-level costs.

    Invariant (regression-tested): ``total_s`` equals what the legacy
    ``execute_batch`` path reported in aggregate —
    ``shared_search_s + shared_train_s + Σ per-query merge_s`` — but
    without corrupting ``reports[0]``'s own timings.
    """

    reports: List[QueryReport]
    opt: BatchResult                 # Alg. 4 plan combination + benefit
    shared_search_s: float
    shared_train_s: float
    materialized: List[MaterializedModel] = field(default_factory=list)
    backend: str = "host"
    merge_device_ms: float = 0.0     # shared bucketed launches (batch total)
    train_device_ms: float = 0.0     # kernel-route shared gap training
    cache_hits: int = 0
    cache_misses: int = 0
    cache_resident_bytes: int = 0
    pad_rows: int = 0                # zero-weight rows across the launches
    plan_cached: bool = False        # Alg. 4 result served from the cache
    fallback_from: Optional[str] = None  # backend lost mid-batch (see above)
    trace: Optional[str] = None      # batch-level trace id (see QueryReport)

    @property
    def merge_s(self) -> float:
        return sum(r.merge_s for r in self.reports)

    @property
    def total_s(self) -> float:
        return self.shared_search_s + self.shared_train_s + self.merge_s

    @property
    def benefit(self) -> float:
        return self.opt.benefit

    def __len__(self) -> int:
        return len(self.reports)

    def __iter__(self) -> Iterator[QueryReport]:
        return iter(self.reports)

    def __getitem__(self, i: int) -> QueryReport:
        return self.reports[i]
