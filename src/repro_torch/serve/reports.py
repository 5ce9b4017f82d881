"""Service-level telemetry — what a multi-tenant operator watches.

``QueryReport``/``BatchReport`` answer *one* query or batch;
``ServiceReport`` answers "how is the service doing": per-tenant queue
waits, coalesce widths and admission outcomes (``TenantStats``),
shared-cache traffic (the cross-session plan cache and the device
model LRU), per-backend latency windows and degradation levels
(``BackendSLO``), the coalescing queues' fusion efficiency and current
depths, tenant-lifecycle churn, and — when streaming ingestion and/or
speculation are attached — the pipeline's freshness/compaction
counters (``IngestReport``) and the speculative trainer's hit ledger
(``SpeculationReport``).  Snapshots are plain frozen dataclasses —
``MLegoService.report()`` reads the tenant/group counters under the
service stats lock (mutually consistent), while the shared-structure
counters (plan cache, backend stats, calibration size) are
point-in-time reads of independently-locked structures: each is valid,
but a query completing mid-snapshot can land between them.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple

from repro_torch.api.backend import BackendStats
from repro_torch.ingest.pipeline import IngestReport
from repro_torch.ingest.speculate import QueryLogEntry, SpeculationReport
from repro_torch.serve.breaker import BreakerSnapshot
from repro_torch.serve.slo import BackendSLO


@dataclass(frozen=True)
class TenantStats:
    """One tenant's view of the service.

    queue_wait_s sums the time each of the tenant's queries sat in the
    coalescing queue before its group started executing (the price of
    the coalescing window); width_sum sums the widths of the groups
    its queries rode in, so ``mean_width`` > 1 means this tenant's
    traffic actually fused with other queries.  ``shed`` and
    ``deadline_rejected`` count queries admission control refused
    (they are *not* in ``queries``, which counts answered/failed
    executions); ``degraded_queries`` counts answers produced under a
    non-zero SLO degradation level; ``evictions`` counts idle-TTL
    session evictions (the session revives on next use with its RNG
    stream intact, so this is lifecycle telemetry, not data loss).
    """

    tenant: str
    queries: int = 0
    errors: int = 0
    queue_wait_s: float = 0.0
    max_queue_wait_s: float = 0.0
    coalesced_queries: int = 0      # answered inside a width>1 group
    width_sum: int = 0
    max_width: int = 0
    plan_cached_queries: int = 0    # answered off the shared plan cache
    shed: int = 0                   # rejected: queue full / waited too long
    deadline_rejected: int = 0      # rejected: deadline_s elapsed queued
    degraded_queries: int = 0       # answered at degradation level > 0
    evictions: int = 0              # idle-TTL session evictions

    @property
    def mean_queue_wait_s(self) -> float:
        return self.queue_wait_s / self.queries if self.queries else 0.0

    @property
    def mean_width(self) -> float:
        return self.width_sum / self.queries if self.queries else 0.0

    def absorb(self, *, wait_s: float, width: int, plan_cached: bool,
               error: bool = False, degraded: bool = False) -> "TenantStats":
        """One answered (or failed) query folded in; returns the new
        frozen snapshot."""
        return replace(
            self,
            queries=self.queries + 1,
            errors=self.errors + (1 if error else 0),
            queue_wait_s=self.queue_wait_s + wait_s,
            max_queue_wait_s=max(self.max_queue_wait_s, wait_s),
            coalesced_queries=self.coalesced_queries + (1 if width > 1 else 0),
            width_sum=self.width_sum + width,
            max_width=max(self.max_width, width),
            plan_cached_queries=self.plan_cached_queries
            + (1 if plan_cached else 0),
            degraded_queries=self.degraded_queries + (1 if degraded else 0))

    def bump(self, **deltas: int) -> "TenantStats":
        """Counter increments (shed / deadline_rejected / evictions)."""
        return replace(self, **{k: getattr(self, k) + v
                                for k, v in deltas.items()})


@dataclass(frozen=True)
class ServiceReport:
    """Point-in-time snapshot of the whole service.

    ``groups``/``coalesced_groups`` count drained execution groups
    (a group is one ``submit_many`` launch when its width > 1);
    ``plan_cache_hits``/``misses`` read the *shared* plan cache, so
    they include hits one tenant earned from another tenant's
    searches; ``backend`` is the shared execution backend's cumulative
    counters (device-cache traffic across every session).

    Hardening telemetry: ``shed``/``deadline_rejected`` are service-
    wide admission rejections, ``bisect_retries`` the fused groups
    re-split after a failed ``submit_many`` (each split halves the
    group — O(log n) per malformed spec), ``queue_depth`` the current
    pending count per worker pool, ``slo`` each backend's sliding latency
    window and active degradation level, ``tenant_evictions`` the
    idle-TTL lifecycle churn and ``active_sessions`` the tenants
    currently resident.

    Fault-tolerance telemetry: ``breaker`` is each backend's circuit-
    breaker snapshot (state, windowed error rate, lifetime opens),
    ``breaker_reroutes`` counts queries routed to a fallback pool
    because their backend's breaker was open (they were answered, not
    shed), and ``retries`` is the shared ``RetryPolicy``'s per-site
    retry ledger (e.g. ``{"backend.merge.device": 3}`` means three
    transient merge faults were absorbed invisibly to clients).
    """

    tenants: Dict[str, TenantStats] = field(default_factory=dict)
    queries: int = 0
    errors: int = 0
    groups: int = 0
    coalesced_groups: int = 0
    max_coalesce_width: int = 0
    width_sum: int = 0
    plan_cache_hits: int = 0
    plan_cache_misses: int = 0
    plan_cache_entries: int = 0
    backend: BackendStats = field(default_factory=BackendStats)
    calibration_samples: int = 0
    store_bytes: int = 0
    shed: int = 0
    deadline_rejected: int = 0
    bisect_retries: int = 0
    degraded_queries: int = 0
    tenant_evictions: int = 0
    active_sessions: int = 0
    queue_depth: Dict[str, int] = field(default_factory=dict)
    slo: Dict[str, BackendSLO] = field(default_factory=dict)
    breaker: Dict[str, BreakerSnapshot] = field(default_factory=dict)
    breaker_reroutes: int = 0
    retries: Dict[str, int] = field(default_factory=dict)
    # JSON snapshot of the service metrics registry (same objects the
    # Prometheus exposition renders, so the two cannot drift); see
    # ``repro_torch.obs.metrics.MetricsRegistry.snapshot``
    metrics: Optional[Dict[str, Any]] = None
    # None unless the corresponding subsystem is attached
    ingest: Optional[IngestReport] = None
    speculation: Optional[SpeculationReport] = None

    @property
    def mean_coalesce_width(self) -> float:
        """Mean width over *groups* (1.0 = nothing ever fused)."""
        return self.width_sum / self.groups if self.groups else 0.0

    @property
    def coalesce_rate(self) -> float:
        """Fraction of queries answered inside a width>1 group."""
        if not self.queries:
            return 0.0
        return sum(t.coalesced_queries for t in self.tenants.values()) \
            / self.queries

    @property
    def submitted(self) -> int:
        """Everything that passed the front door: answered + failed +
        admission-rejected."""
        return self.queries + self.shed + self.deadline_rejected

    @property
    def shed_rate(self) -> float:
        """Fraction of submitted queries admission control refused."""
        total = self.submitted
        return (self.shed + self.deadline_rejected) / total if total else 0.0

    @property
    def degraded_frac(self) -> float:
        """Fraction of answered queries produced at level > 0."""
        return self.degraded_queries / self.queries if self.queries else 0.0

    def tenant(self, name: str) -> TenantStats:
        return self.tenants.get(name, TenantStats(tenant=name))


__all__ = ["BackendSLO", "BreakerSnapshot", "IngestReport",
           "QueryLogEntry", "ServiceReport", "SpeculationReport",
           "TenantStats"]
