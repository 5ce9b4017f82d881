"""MLego serving layer — multi-tenant queries over one shared store.

    from repro_torch.serve import MLegoService
    from repro_torch.api import Interval, QuerySpec

    svc = MLegoService(corpus, cfg, backend="device", device="cuda",
                       max_queue=256, slo_p95_s=0.25, tenant_ttl_s=600.0)
    fut = svc.submit(QuerySpec(sigma=Interval(0.0, 500.0)), tenant="ana",
                     deadline_s=1.0, priority=1)
    report = fut.result()

One ``ModelStore``, one execution backend per *name* (one device model
LRU), one cross-session ``PlanCache``, one calibration log — shared by
every tenant.  Each backend name gets its own worker pool (host and
device traffic never serialize against each other; idle workers steal
across pools), concurrent specs coalesce into Alg. 4 batches inside a
configurable time/size window, bounded queues shed load with typed
``ShedError``/``DeadlineExceededError`` rejections, a sliding-latency
SLO loop degrades plan quality (effective α) under overload, and idle
tenant sessions are evicted on a TTL and revived with their RNG stream
intact.  ``attach_ingest``/``attach_speculator`` add streaming
ingestion and workload-driven gap pre-training (``repro_torch.ingest``).
Per-backend circuit breakers (``repro_torch.serve.breaker``) quarantine a
backend whose error window trips and reroute its traffic down the
fallback chain until a half-open probe re-admits it.  The reference
package's tour, ``src/repro/api/README.md``, describes all of it in its
"Serving layer", "Streaming ingestion & speculation" and "Failure
semantics" sections.
"""
from repro_torch.serve.breaker import (
    CLOSED,
    HALF_OPEN,
    OPEN,
    BreakerPolicy,
    BreakerSnapshot,
    CircuitBreaker,
)
from repro_torch.serve.queue import (
    CoalescingQueue,
    DeadlineExceededError,
    PendingQuery,
    ServiceClosedError,
    ShedError,
    SubmitOptions,
)
from repro_torch.serve.reports import (
    BackendSLO,
    IngestReport,
    QueryLogEntry,
    ServiceReport,
    SpeculationReport,
    TenantStats,
)
from repro_torch.serve.service import DEFAULT_TENANT, MLegoService
from repro_torch.serve.slo import LatencyTracker, SLOPolicy

__all__ = [
    "BackendSLO",
    "BreakerPolicy",
    "BreakerSnapshot",
    "CLOSED",
    "CircuitBreaker",
    "CoalescingQueue",
    "DEFAULT_TENANT",
    "DeadlineExceededError",
    "HALF_OPEN",
    "OPEN",
    "IngestReport",
    "LatencyTracker",
    "MLegoService",
    "PendingQuery",
    "QueryLogEntry",
    "SLOPolicy",
    "ServiceClosedError",
    "ServiceReport",
    "ShedError",
    "SpeculationReport",
    "SubmitOptions",
    "TenantStats",
]
