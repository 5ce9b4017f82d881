"""``MLegoService`` — the multi-tenant front door over one shared store.

``MLegoSession`` is a single-caller object: its plan cache, device
model LRU, and calibration log are private, so every concurrent
analyst over the same materialized capital rebuilds all three.  The
service owns exactly one of each — one ``ModelStore``, one execution
backend per *name* (one device LRU), one store-homed ``PlanCache``,
one cost provider (one calibration log) — and hands every tenant a
session wired to the shared set:

    svc = MLegoService(corpus, cfg, backend="device", device="cuda",
                       window_s=0.005, max_queue=256, slo_p95_s=0.25,
                       tenant_ttl_s=600.0)
    svc.train_range(0.0, 500.0)                   # shared capital
    fut = svc.submit(QuerySpec(sigma=Interval(0.0, 1000.0)),
                     tenant="ana", deadline_s=1.0, priority=1)
    report = fut.result()                         # a QueryReport

``submit`` is asynchronous and keyword-only past the spec: specs land
on a per-backend **coalescing queue** and that backend's **worker
pool** drains it in time/size windows — host and device traffic never
serialize against each other, and a pool's extra workers steal pending
items from other pools when their own queue is idle.  Specs that
drained together and are compatible — same trainer kind, same
execution backend; α may differ, the session's α-split machinery
handles it — are fused into one ``submit_many`` call, so independent
interactive users ride Alg. 4's joint planning (shared gap segments
trained once) and the ragged segmented merge launch instead of
issuing n serial single-query merges.  A group whose fused execution
fails is **bisected**: each half retries fused, recursively, so one
malformed spec is isolated in O(log n) retries while its healthy
window neighbors keep their shared-segment training — not the n
serial re-executions a query-by-query fallback would pay
(``ServiceReport.bisect_retries`` counts the splits).

Production hardening:

  * **Admission control** — ``max_queue`` bounds each pool's queue
    (full ⇒ ``ShedError`` at the submitter, or displacement of the
    youngest lower-priority pending query); ``deadline_s`` /
    ``max_queue_wait_s`` expire queued queries with typed
    ``DeadlineExceededError`` / ``ShedError`` *before* execution burns
    capacity on answers nobody is waiting for.
  * **SLO feedback** — a sliding p50/p95/p99 latency window per
    backend (``slo_p95_s`` or a full ``SLOPolicy``) degrades new
    queries under overload: effective α is scaled down (level 1), then
    forced to the fast end unless the original-α plan is already
    cached, with speculative training paused (level ≥ 2).  The level
    is recorded on every ``QueryReport.degraded``.
  * **Tenant lifecycle** — ``tenant_ttl_s`` evicts idle tenant
    sessions (their stats survive); a revived tenant continues its
    *exact* RNG stream (the session generator's state is stashed at
    eviction), so results are reproducible across eviction boundaries.
  * **Circuit breakers** — a lost device (``DeviceLostError``) is a
    hard failure for its backend's breaker; an open breaker reroutes
    that backend's groups down the fallback chain, and their reports
    name the backend they left in ``fallback_from``.  On a device
    backend nothing else counts: a kernel that fails to build or launch
    (``KernelError``) fails its query and nothing more, so no breaker
    moves a device's work to the host's plain code for it.

Cross-session reuse is the point: tenant B's repeated query over a
plan tenant A already searched reports ``plan_cached=True``, and its
merge reads A's device-resident model parameters as cache hits.
Per-tenant queue waits, coalesce widths and admission outcomes land on
``ServiceReport`` (``svc.report()``).

The service is also the host for the streaming subsystems
(``repro_torch.ingest``): ``attach_ingest`` wires an ``IngestPipeline`` to
the shared store — grown corpus snapshots re-home every tenant session
*before* slice models land, so a query over freshly ingested documents
is answered with no manual store mutation — and ``attach_speculator``
starts a ``SpeculativeTrainer`` over the service's query log (every
answered query is logged with its σ/kind/α and arrival time).  Both
are drained and joined by ``close()``.  Answered plans are checked
against the speculator's trained set, so speculative hits surface on
the report.
"""
from __future__ import annotations

import threading
import time
import warnings
import zlib
from collections import deque
from concurrent.futures import Future
from dataclasses import replace as _dc_replace
from typing import Deque, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.api.backend import (DeviceBackend, ExecutionBackend,
                                     make_backend)
from repro_torch.api.planner import PlanCache
from repro_torch.api.session import MLegoSession
from repro_torch.api.spec import QuerySpec
from repro_torch.api.trainers import resolve_kind
from repro_torch.configs.lda_default import LDAConfig
from repro_torch.core.cost import CostProvider
from repro_torch.core.errors import (DeviceLostError, ExecutionError, RetryPolicy)
from repro_torch.core.lda import MaterializedModel
from repro_torch.core.store import ModelStore
from repro_torch.data.corpus import Corpus
from repro_torch.kernels.common import resolve_device
from repro_torch.serve.breaker import (OPEN, BreakerPolicy, CircuitBreaker)
from repro_torch.testing.faults import maybe_fail
from repro_torch.ingest.compaction import CompactionPolicy, Compactor
from repro_torch.ingest.pipeline import IngestPipeline
from repro_torch.ingest.speculate import QueryLogEntry, SpeculativeTrainer
from repro_torch.serve.queue import (
    CoalescingQueue,
    DeadlineExceededError,
    PendingQuery,
    ServiceClosedError,
    ShedError,
    SubmitOptions,
)
from repro_torch.obs.metrics import HistogramView, MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.serve.reports import BackendSLO, ServiceReport, TenantStats
from repro_torch.serve.slo import SLOPolicy

_BREAKER_STATE_CODE = {"closed": 0, "half_open": 1, "open": 2}

DEFAULT_TENANT = "default"


def _resolve(future: "Future", result) -> None:
    """Set a result, tolerating futures a client already finalized —
    the worker must never die over one future's state."""
    try:
        future.set_result(result)
    except Exception:
        pass


def _reject(future: "Future", exc: BaseException) -> None:
    try:
        future.set_exception(
            exc if isinstance(exc, Exception) else RuntimeError(repr(exc)))
    except Exception:
        pass


class _Pool:
    """One backend *instance*'s worker pool: a coalescing queue plus
    its drain threads.  Worker 0 is the *home* worker (drains only this
    queue — a stall in another pool can never capture it); workers
    1..n-1 steal from sibling pools when this queue is idle.  ``name``
    is the display label (the backend's name, ``#k``-suffixed when two
    distinct instances share one)."""

    def __init__(self, name: str, queue: CoalescingQueue):
        self.name = name
        self.queue = queue
        self.threads: List[threading.Thread] = []


class MLegoService:
    """One shared store, many tenants, per-backend worker pools.

    corpus/cfg       : the Def. 1 D and F every tenant shares
    store            : shared ``ModelStore`` (fresh one if omitted)
    kind             : default trainer kind for specs that name none
    backend          : the *shared* execution backend ("host"/"device"
                       or an instance) — one device LRU for everyone
    cost             : shared cost provider ("analytic"/"calibrated"/
                       instance); a calibrated provider accumulates one
                       calibration log across all tenants
    calibration_path : sidecar to warm-start from and to merge-save
                       into on ``close()``
    window_s         : coalescing window — max extra latency a query
                       pays to let neighbors fuse with it
    max_width        : cap on one coalesced group's size
    seed             : base RNG seed; each tenant's session derives a
                       stable per-tenant stream from it
    workers_per_pool : drain threads per backend pool (>= 1; worker 0
                       never steals, the rest do)
    max_queue        : bound on each pool's pending queries (None =
                       unbounded); see ``repro_torch.serve.queue`` for the
                       full-queue displacement/rejection rule
    slo_p95_s        : p95 latency objective per backend — enables the
                       SLO degradation loop (or pass ``slo=`` a full
                       ``SLOPolicy`` for custom thresholds)
    tenant_ttl_s     : idle TTL for tenant sessions (None = immortal);
                       evicted tenants revive on next use with their
                       RNG stream intact
    device           : where every tenant session, backend and ingest
                       slice runs ("cuda" unless the caller asks for
                       the CPU; asking for CUDA without a card raises)
    profile          : profiler ranges and launch features on the
                       device backends' launches (``obs.profile``)
    """

    def __init__(self, corpus: Corpus, cfg: LDAConfig, *,
                 store: Optional[ModelStore] = None,
                 kind: str = "vb",
                 backend: Union[str, ExecutionBackend] = "host",
                 cost: Union[CostProvider, str, None] = None,
                 calibration_path: Optional[str] = None,
                 window_s: float = 0.005, max_width: int = 16,
                 plan_cache_entries: int = 1024,
                 seed: int = 0, poll_s: float = 0.02,
                 query_log_entries: int = 512,
                 workers_per_pool: int = 2,
                 max_queue: Optional[int] = None,
                 slo_p95_s: Optional[float] = None,
                 slo: Optional[SLOPolicy] = None,
                 slo_window: int = 256,
                 tenant_ttl_s: Optional[float] = None,
                 breaker: Optional[BreakerPolicy] = None,
                 retry: Optional[RetryPolicy] = None,
                 tracer: Optional[Tracer] = None,
                 registry: Optional[MetricsRegistry] = None,
                 profile: bool = False,
                 device: Union[str, torch.device, None] = "cuda"):
        if workers_per_pool < 1:
            raise ValueError(
                f"workers_per_pool must be >= 1, got {workers_per_pool}")
        if tenant_ttl_s is not None and tenant_ttl_s < 0:
            raise ValueError(
                f"tenant_ttl_s must be >= 0, got {tenant_ttl_s}")
        self.corpus = corpus
        self.cfg = cfg
        self.store = store if store is not None else ModelStore()
        self.kind = resolve_kind(kind)
        self.device = resolve_device(device)
        self._profile = profile
        self.backend = make_backend(backend, device=self.device,
                                    profile=profile) \
            if isinstance(backend, str) else backend
        self.plan_cache = PlanCache(max_entries=plan_cache_entries)
        self.cost = MLegoSession._make_cost(cost, cfg, calibration_path)
        self.calibration_path = calibration_path
        self._seed = seed
        self._poll_s = poll_s
        self._window_s = window_s
        self._max_width = max_width
        self._max_queue = max_queue
        self.workers_per_pool = workers_per_pool
        self.tenant_ttl_s = tenant_ttl_s
        if slo is not None:
            self._slo_policy: Optional[SLOPolicy] = slo
        else:
            self._slo_policy = SLOPolicy(p95_slo_s=slo_p95_s) \
                if slo_p95_s is not None else None
        self._slo_window = slo_window
        # observability: one tracer (shared with every tenant session,
        # so worker-thread spans land in one exportable buffer) and one
        # metrics registry (the single source of truth for the
        # service's counters — ``report()`` reads the same objects the
        # Prometheus exposition renders)
        self.tracer = tracer if tracer is not None else Tracer(
            capacity=65536)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._build_metrics()
        # one retry policy shared by every tenant session, so the
        # report's per-site retry counters aggregate service-wide
        self.retry = retry if retry is not None else RetryPolicy()
        # per-backend-identity circuit breakers (lazily built, like
        # pools); the transition hook mirrors breaker state into the
        # backend quarantine flag so sessions' fallback chains and the
        # service's reroutes agree on who is healthy
        self._breaker_policy = breaker if breaker is not None \
            else BreakerPolicy()
        self._breakers: Dict[int, CircuitBreaker] = {}
        self._breaker_names: Dict[int, str] = {}
        self._breaker_lock = threading.Lock()

        self._sessions: Dict[str, MLegoSession] = {}
        self._session_lock = threading.RLock()
        # tenant lifecycle: last-use stamps, stashed RNG states of
        # evicted sessions (stream continuity on revival), in-flight
        # query counts (a tenant with queued/executing work is never
        # evicted — its session object is being used right now)
        self._last_seen: Dict[str, float] = {}
        self._evicted_gens: Dict[str, torch.Tensor] = {}
        self._inflight: Dict[str, int] = {}
        self._last_sweep = time.monotonic()
        # corpus snapshot epoch: revived/new sessions inherit it so a
        # plan cached before ingestion growth (epoch-0 keys) can never
        # be served to a session created after the growth
        self._data_epoch = 0
        # shared per-name backends for specs naming a non-default
        # backend — one device LRU per backend *name*, not per tenant
        self._extra_backends: Dict[str, ExecutionBackend] = {}

        # rolling per-tenant query log — the speculator's ore
        self._query_log: Deque[QueryLogEntry] = deque(
            maxlen=query_log_entries)
        self._ingest: Optional[IngestPipeline] = None
        self._speculator: Optional[SpeculativeTrainer] = None

        self._stats_lock = threading.Lock()
        self._tenants: Dict[str, TenantStats] = {}
        # width aggregates stay plain ints under the stats lock (they
        # pair with the TenantStats updates); everything countable
        # lives natively in the metrics registry (see _build_metrics)
        self._width_sum = self._max_coalesce_width = 0

        self._closed = False
        self._stop = threading.Event()
        # keyed by backend instance identity
        self._pools: Dict[int, _Pool] = {}
        self._pool_lock = threading.Lock()
        self._pool_for(self.backend)            # default pool, eagerly

    # ------------------------------------------------------------------
    # metrics
    # ------------------------------------------------------------------
    def _build_metrics(self) -> None:
        """Register the service's metric families.

        *Native* counters are the service's only copy of the number —
        ``report()`` reads them back, so the Prometheus exposition and
        the ``ServiceReport`` can never disagree.  Structures with
        their own locking discipline (``BackendStats``, breakers, the
        retry ledger, caches) stay the writers and are *mirrored* into
        the registry by a pre-scrape callback reading the same live
        sources ``report()`` reads.
        """
        reg = self.registry
        c, g, h = reg.counter, reg.gauge, reg.histogram
        self._m_queries = c("mlego_queries_total",
                            "Answered or failed query executions")
        self._m_errors = c("mlego_query_errors_total",
                           "Query executions that raised")
        self._m_groups = c("mlego_groups_total",
                           "Drained execution groups")
        self._m_coalesced = c("mlego_coalesced_groups_total",
                              "Groups of width > 1 (fused submit_many)")
        self._m_shed = c("mlego_shed_total",
                         "Queries refused: full queue, displacement, "
                         "or overwait")
        self._m_deadline = c("mlego_deadline_rejected_total",
                             "Queries expired in queue past deadline_s")
        self._m_degraded = c("mlego_degraded_queries_total",
                             "Answers produced under SLO degradation",
                             labelnames=("level",))
        self._m_evictions = c("mlego_tenant_evictions_total",
                              "Idle-TTL tenant session evictions")
        self._m_bisect = c("mlego_bisect_retries_total",
                           "Fused groups split after a failed batch")
        self._m_reroutes = c("mlego_breaker_reroutes_total",
                             "Queries routed to a fallback pool by an "
                             "open breaker")
        self._m_transitions = c("mlego_breaker_transitions_total",
                                "Breaker state transitions",
                                labelnames=("backend", "to"))
        self._m_latency = h("mlego_serve_latency_seconds",
                            "Client-observed latency (enqueue to answer)",
                            labelnames=("backend",),
                            window=self._slo_window)
        # mirrored families (synced by _sync_mirrors at scrape time)
        self._m_queue_depth = g("mlego_queue_depth",
                                "Pending queries per worker pool",
                                labelnames=("pool",))
        self._m_plan_hits = c("mlego_plan_cache_hits_total",
                              "Shared plan cache hits")
        self._m_plan_misses = c("mlego_plan_cache_misses_total",
                                "Shared plan cache misses")
        self._m_plan_entries = g("mlego_plan_cache_entries",
                                 "Shared plan cache residency")
        self._m_store_bytes = g("mlego_store_bytes",
                                "Materialized model store size")
        self._m_cal_samples = g("mlego_calibration_samples",
                                "Cost-calibration log size")
        self._m_cal_refits = c("mlego_calibration_refits_total",
                               "Cost-model refit generations")
        self._m_active = g("mlego_active_sessions",
                           "Tenant sessions currently resident")
        self._m_retries = c("mlego_retries_total",
                            "Transient-failure retries per site",
                            labelnames=("site",))
        self._m_hit_bytes = c("mlego_cache_hit_bytes_total",
                              "Bytes read from the device model cache",
                              labelnames=("backend",))
        self._m_miss_bytes = c("mlego_cache_miss_bytes_total",
                               "Bytes uploaded host-to-device on cache "
                               "misses", labelnames=("backend",))
        self._m_cache_evict = c("mlego_cache_evictions_total",
                                "Device model cache LRU evictions",
                                labelnames=("backend",))
        self._m_pad_rows = c("mlego_pad_rows_total",
                             "Zero-weight rows in batched merge launches",
                             labelnames=("backend",))
        self._m_resident = g("mlego_cache_resident_bytes",
                             "Device model cache residency",
                             labelnames=("backend",))
        self._m_breaker_state = g("mlego_breaker_state",
                                  "Breaker state (0 closed, 1 half-open, "
                                  "2 open)", labelnames=("backend",))
        self._m_breaker_opens = c("mlego_breaker_opens_total",
                                  "Lifetime breaker open transitions",
                                  labelnames=("backend",))
        self._m_width_sum = c("mlego_coalesce_width_sum_total",
                              "Sum of executed group widths")
        self._m_max_width = g("mlego_max_coalesce_width",
                              "Widest group executed so far")
        reg.add_callback(self._sync_mirrors)

    def _sync_mirrors(self) -> None:
        """Pre-scrape sync: copy externally-owned counters into their
        registry mirrors.  Reads exactly the live structures
        ``report()`` reads, so a quiesced service exposes identical
        numbers on both surfaces."""
        for p in self._pools_snapshot():
            self._m_queue_depth.set(len(p.queue), pool=p.name)
        self._m_plan_hits.set_floor(self.plan_cache.hits)
        self._m_plan_misses.set_floor(self.plan_cache.misses)
        self._m_plan_entries.set(len(self.plan_cache))
        self._m_store_bytes.set(self.store.nbytes())
        cal = getattr(self.cost, "calibration", None)
        self._m_cal_samples.set(len(cal) if cal is not None else 0)
        self._m_cal_refits.set_floor(getattr(self.cost, "version", 0))
        with self._session_lock:
            self._m_active.set(len(self._sessions))
            backends = dict(self._extra_backends)
        backends.setdefault(self.backend.name, self.backend)
        for site, n in self.retry.snapshot().items():
            self._m_retries.set_floor(n, site=site)
        for name, b in backends.items():
            st = b.stats
            self._m_hit_bytes.set_floor(st.cache_hit_bytes, backend=name)
            self._m_miss_bytes.set_floor(st.cache_miss_bytes, backend=name)
            self._m_cache_evict.set_floor(st.cache_evictions, backend=name)
            self._m_pad_rows.set_floor(st.pad_rows, backend=name)
            self._m_resident.set(st.cache_resident_bytes, backend=name)
        with self._breaker_lock:
            blist = [(self._breaker_names[k], cb)
                     for k, cb in self._breakers.items()]
        for name, cb in blist:
            snap = cb.snapshot()
            self._m_breaker_state.set(
                _BREAKER_STATE_CODE.get(snap.state, -1), backend=name)
            self._m_breaker_opens.set_floor(snap.opens, backend=name)
        with self._stats_lock:
            self._m_width_sum.set_floor(self._width_sum)
            self._m_max_width.set(self._max_coalesce_width)

    def metrics_text(self) -> str:
        """Prometheus text exposition (format 0.0.4) of the registry —
        the scrape endpoint's payload."""
        return self.registry.exposition()

    def export_trace(self, path: str) -> None:
        """Write the tracer's ring buffer as Chrome trace-event JSON
        (loads in Perfetto / ``chrome://tracing``)."""
        self.tracer.export_chrome(path)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def __enter__(self) -> "MLegoService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Stop accepting queries, stop speculation, drain the ingest
        builder (the open partial slice is built — append-only means it
        can never grow again), drain everything pending, join every
        pool's workers, and (for a calibrated provider with a sidecar
        path) merge-save the shared calibration log."""
        if self._speculator is not None:
            self._speculator.close()
        if self._ingest is not None:
            self._ingest.close()
        first = not self._closed
        self._closed = True
        with self._pool_lock:
            pools = list(self._pools.values())
        for p in pools:
            p.queue.close()
        self._stop.set()
        for p in pools:
            for t in p.threads:
                if t.is_alive():
                    t.join()
        if first and self.calibration_path is not None \
                and getattr(self.cost, "calibration", None) is not None:
            self.save_calibration()

    # ------------------------------------------------------------------
    # worker pools
    # ------------------------------------------------------------------
    def _pool_for(self, backend: ExecutionBackend) -> _Pool:
        """The worker pool owning this backend *instance*'s traffic,
        created lazily — a service that never sees device specs never starts
        device workers.  Keyed by instance identity, not ``.name``:
        two distinct backends that happen to share a name (a custom
        instance passed at construction alongside a factory-made
        sibling) must never share a queue, or one's stall would
        head-of-line block the other's traffic."""
        key = id(backend)
        with self._pool_lock:
            pool = self._pools.get(key)
            if pool is None:
                if self._closed:
                    raise ServiceClosedError("service is closed")
                name = backend.name
                taken = {p.name for p in self._pools.values()}
                if name in taken:
                    dups = sum(1 for p in self._pools.values()
                               if p.name.split("#")[0] == name)
                    name = f"{name}#{dups + 1}"
                pool = _Pool(name, CoalescingQueue(
                    window_s=self._window_s, max_width=self._max_width,
                    max_queue=self._max_queue, on_shed=self._note_displaced))
                self._pools[key] = pool
                for i in range(self.workers_per_pool):
                    t = threading.Thread(
                        target=self._run,
                        args=(pool, i > 0),
                        name=f"mlego-serve-{name}-{i}", daemon=True)
                    pool.threads.append(t)
                    t.start()
            return pool

    def _pools_snapshot(self) -> List[_Pool]:
        with self._pool_lock:
            return list(self._pools.values())

    # ------------------------------------------------------------------
    # tenants
    # ------------------------------------------------------------------
    def _tenant_seed(self, tenant: str) -> int:
        # stable across runs and processes (no hash randomization)
        return (self._seed + zlib.crc32(tenant.encode("utf-8"))) & 0x7FFFFFFF

    def session(self, tenant: str = DEFAULT_TENANT) -> MLegoSession:
        """The tenant's session — lazily built, permanently wired to
        the shared store/backend/plan-cache/cost provider.  Usable
        directly for synchronous work (capital building, debugging);
        interactive traffic should go through ``submit``.  A tenant
        evicted by the idle TTL revives here with its stashed RNG state,
        so its result stream continues exactly where eviction cut it.
        """
        with self._session_lock:
            sess = self._sessions.get(tenant)
            if sess is None:
                sess = MLegoSession(
                    self.corpus, self.cfg, store=self.store,
                    cost=self.cost, kind=self.kind,
                    seed=self._tenant_seed(tenant),
                    backend=self.backend, plan_cache=self.plan_cache,
                    retry=self.retry, tracer=self.tracer,
                    device=self.device)
                # the breaker feed rides the session's outcome hook, so
                # *direct* session use (tenants bypassing the front
                # door) counts toward backend health exactly like
                # worker-pool traffic
                sess.on_outcome = self._session_outcome
                for b in self._extra_backends.values():
                    sess.adopt_backend(b)
                saved = self._evicted_gens.pop(tenant, None)
                if saved is not None:
                    # RNG-stream continuity across eviction: the fresh
                    # session resumes the evicted session's stream
                    with sess._gen_lock:
                        sess._gen.set_state(saved)
                sess._data_epoch = self._data_epoch
                self._sessions[tenant] = sess
            self._last_seen[tenant] = time.monotonic()
            return sess

    def tenants(self) -> Tuple[str, ...]:
        with self._session_lock:
            return tuple(sorted(self._sessions))

    def evict_idle(self, idle_s: Optional[float] = None) -> int:
        """Evict tenant sessions idle longer than ``idle_s`` (defaults
        to the service's ``tenant_ttl_s``); returns the count.  A
        tenant with queued or executing work is skipped.  The evicted
        session's RNG state is stashed so revival continues its stream;
        its ``TenantStats`` survive (eviction is lifecycle, not data
        loss)."""
        ttl = idle_s if idle_s is not None else self.tenant_ttl_s
        if ttl is None:
            raise ValueError("no TTL: pass idle_s= or construct the "
                             "service with tenant_ttl_s=")
        now = time.monotonic()
        evicted = 0
        with self._session_lock:
            for tenant in list(self._sessions):
                if now - self._last_seen.get(tenant, now) < ttl:
                    continue
                with self._stats_lock:
                    busy = self._inflight.get(tenant, 0) > 0
                if busy:
                    continue
                sess = self._sessions.pop(tenant)
                with sess._gen_lock:
                    self._evicted_gens[tenant] = sess._gen.get_state()
                self._last_seen.pop(tenant, None)
                evicted += 1
                self._m_evictions.inc()
                with self._stats_lock:
                    ts = self._tenants.get(tenant,
                                           TenantStats(tenant=tenant))
                    self._tenants[tenant] = ts.bump(evictions=1)
        return evicted

    def _maybe_evict(self) -> None:
        """Throttled idle-loop TTL sweep (any pool's idle worker)."""
        ttl = self.tenant_ttl_s
        if ttl is None:
            return
        now = time.monotonic()
        if now - self._last_sweep < max(ttl / 4.0, self._poll_s):
            return
        self._last_sweep = now
        self.evict_idle()

    def _shared_backend(self, name: str) -> ExecutionBackend:
        """The service-wide backend for ``name`` — the default instance
        when the name matches, else one shared per-name instance
        adopted into every tenant session.  Without this, a spec naming
        a non-default backend would silently get a *private* per-
        session instance (one device LRU per tenant — no cross-tenant
        reuse, invisible to the service report)."""
        if name == self.backend.name:
            return self.backend
        with self._session_lock:
            b = self._extra_backends.get(name)
            if b is None:
                b = make_backend(name, device=self.device,
                                 profile=self._profile)
                b.bind_store(self.store)
                self._extra_backends[name] = b
                for sess in self._sessions.values():
                    sess.adopt_backend(b)
            return b

    # ------------------------------------------------------------------
    # circuit breakers
    # ------------------------------------------------------------------
    def _instance_for(self, name: str) -> ExecutionBackend:
        """The service-wide backend instance behind ``name``."""
        if name == self.backend.name:
            return self.backend
        return self._shared_backend(name)

    def _breaker_for(self, backend: ExecutionBackend) -> CircuitBreaker:
        """This backend instance's breaker, lazily built.  The
        transition hook quarantines the backend on → open (sessions'
        fallback chains then skip it) and un-quarantines on any other
        transition (half-open probes and re-closure re-admit it)."""
        with self._breaker_lock:
            cb = self._breakers.get(id(backend))
            if cb is None:
                name = backend.name
                taken = set(self._breaker_names.values())
                if name in taken:
                    dups = sum(1 for v in self._breaker_names.values()
                               if v.split("#")[0] == name)
                    name = f"{name}#{dups + 1}"

                def _mirror(old: str, new: str,
                            _b: ExecutionBackend = backend,
                            _name: str = name) -> None:
                    if new == OPEN:
                        _b.quarantine()
                    else:
                        _b.unquarantine()
                    self._m_transitions.inc(backend=_name, to=new)
                    now = time.perf_counter()
                    self.tracer.record(
                        "breaker.transition", "serve", now, now,
                        trace_id=self.tracer.new_trace_id(),
                        attrs={"backend": _name, "from": old, "to": new})
                cb = CircuitBreaker(self._breaker_policy,
                                    on_transition=_mirror)
                self._breakers[id(backend)] = cb
                self._breaker_names[id(backend)] = name
            return cb

    def _reroute_target(self, name: str) -> Optional[str]:
        """First backend down the fallback chain whose breaker admits
        traffic (None when the whole chain is open)."""
        nxt = MLegoSession._FALLBACK.get(name)
        while nxt is not None:
            if self._breaker_for(self._instance_for(nxt)).allow():
                return nxt
            nxt = MLegoSession._FALLBACK.get(nxt)
        return None

    def _note_outcome(self, answered_by: Optional[str],
                      fallback_from: Optional[str]) -> None:
        """Feed the breakers from one answered query/batch: a report
        carrying ``fallback_from`` means that backend was lost mid-
        query (the session absorbed the ``DeviceLostError`` and
        replayed downstream) — a hard failure for its breaker — while
        the answering backend records a success."""
        if fallback_from is not None:
            self._breaker_for(self._instance_for(fallback_from)) \
                .record_failure(hard=True)
        if answered_by is not None:
            self._breaker_for(self._instance_for(answered_by)) \
                .record_success()

    def _session_outcome(self, answered_by: str,
                         fallback_from: Optional[str],
                         error: Optional[BaseException]) -> None:
        """Tenant sessions' outcome hook — the *single* breaker feed.

        Fires inside ``MLegoSession.submit``/``submit_many`` whether
        the call came from a worker pool or from a tenant holding the
        session directly, so direct use can no longer bypass backend
        health accounting (the worker paths deliberately do not feed
        the breakers themselves — that would double-count)."""
        if error is not None:
            self._note_error(error, answered_by)
        else:
            self._note_outcome(answered_by, fallback_from)

    def _note_error(self, exc: BaseException, backend_name: str) -> None:
        """Feed the breakers from one failed query.  A lost device is a
        hard failure for its backend.  On a device backend that is the
        only failure that counts: a ``KernelError`` (or any other error
        there) fails its query and nothing more, so the breaker never
        reroutes a device's later groups to the host's plain code.
        Elsewhere a typed execution error is a soft failure; a spec
        error (empty predicate, bad α) says nothing about backend
        health."""
        if isinstance(exc, DeviceLostError):
            name = exc.backend or backend_name
            self._breaker_for(self._instance_for(name)) \
                .record_failure(hard=True)
        elif isinstance(exc, ExecutionError):
            backend = self._instance_for(backend_name)
            if not isinstance(backend, DeviceBackend):
                self._breaker_for(backend).record_failure()

    # ------------------------------------------------------------------
    # front door
    # ------------------------------------------------------------------
    def submit(self, spec: QuerySpec, *args,
               tenant: str = DEFAULT_TENANT,
               deadline_s: Optional[float] = None,
               priority: int = 0,
               max_queue_wait_s: Optional[float] = None,
               options: Optional[SubmitOptions] = None) -> "Future":
        """Enqueue one query; resolves to its ``QueryReport``.

        Everything past ``spec`` is keyword-only: ``tenant`` names the
        submitting tenant, ``deadline_s``/``priority``/
        ``max_queue_wait_s`` are the admission-control options (or pass
        a prebuilt ``SubmitOptions`` via ``options=`` — explicit
        keywords win).  Raises ``ServiceClosedError`` after ``close()``
        and ``ShedError`` when the bounded queue is full with nothing
        lower-priority to displace.  The future raises what the query
        raised (e.g. ``ValueError`` for an empty predicate, or
        ``DeadlineExceededError``/``ShedError`` when admission control
        expired it in the queue) — never its coalescing neighbors'
        errors.
        """
        if args:
            # one-release shim for the older positional-tenant call site
            if len(args) > 1:
                raise TypeError(
                    f"submit() takes one positional argument (spec); "
                    f"pass tenant= and admission options as keywords")
            warnings.warn(
                "positional tenant in MLegoService.submit is deprecated; "
                "use submit(spec, tenant=...)",
                DeprecationWarning, stacklevel=2)
            tenant = args[0]
        if self._closed:
            raise ServiceClosedError("service is closed")
        if options is None:
            opts = SubmitOptions(deadline_s=deadline_s, priority=priority,
                                 max_queue_wait_s=max_queue_wait_s)
        else:
            opts = options
            if (deadline_s is not None or priority != 0
                    or max_queue_wait_s is not None):
                opts = SubmitOptions(
                    deadline_s=deadline_s if deadline_s is not None
                    else options.deadline_s,
                    priority=priority if priority != 0
                    else options.priority,
                    max_queue_wait_s=max_queue_wait_s
                    if max_queue_wait_s is not None
                    else options.max_queue_wait_s)
        self.session(tenant)           # construct early: fail fast here
        inst = self.backend
        if spec.backend is not None:
            # route named backends to the shared per-name instance
            # before the worker executes (registers into every session)
            inst = self._shared_backend(spec.backend)
        # the trace root is minted here, on the submitting thread; the
        # pool worker records spans onto the pre-allocated ids, so the
        # per-query tree survives the thread hop (and coalescing)
        item = PendingQuery(spec=spec, tenant=tenant, options=opts,
                            trace_id=self.tracer.new_trace_id(),
                            root_span_id=self.tracer.new_span_id())
        pool = self._pool_for(inst)
        try:
            pool.queue.put(item)
        except ShedError:
            self._m_shed.inc()
            with self._stats_lock:
                ts = self._tenants.get(tenant, TenantStats(tenant=tenant))
                self._tenants[tenant] = ts.bump(shed=1)
            raise
        return item.future

    def _note_displaced(self, victim: PendingQuery) -> None:
        """Queue callback: a pending query was displaced by a higher-
        priority arrival (its future already failed with ShedError)."""
        self._m_shed.inc()
        with self._stats_lock:
            ts = self._tenants.get(victim.tenant,
                                   TenantStats(tenant=victim.tenant))
            self._tenants[victim.tenant] = ts.bump(shed=1)

    def train_range(self, lo: float, hi: float,
                    kind: Optional[str] = None,
                    tenant: str = DEFAULT_TENANT
                    ) -> Optional[MaterializedModel]:
        """Synchronous capital building into the shared store."""
        return self.session(tenant).train_range(lo, hi, kind)

    def save_calibration(self, path: Optional[str] = None) -> str:
        path = path or self.calibration_path
        if path is None:
            raise ValueError("no calibration path: pass one here or set "
                             "calibration_path= on the service")
        cal = getattr(self.cost, "calibration", None)
        if cal is None:
            raise ValueError("service cost provider is not calibrated; "
                             "nothing to persist")
        cal.save(path)                  # merge-on-save (concurrent-safe)
        return path

    # ------------------------------------------------------------------
    # SLO feedback
    # ------------------------------------------------------------------
    def _tracker(self, backend_name: str) -> HistogramView:
        """One backend's latency window, as a sliding-window view over
        the shared ``mlego_serve_latency_seconds`` histogram — the SLO
        control loop and the Prometheus exposition read one structure,
        fed by one ``observe()`` per answered query."""
        return self._m_latency.view(backend=backend_name)

    def _degrade_level(self, backend_name: str) -> int:
        if self._slo_policy is None:
            return 0
        return self._slo_policy.level(self._tracker(backend_name))

    def _degrade_spec(self, spec: QuerySpec, level: int,
                      sess: MLegoSession) -> QuerySpec:
        """The SLO loop's dial: under load, turn α toward the fast end
        — *unless* the original-α plan is already cached (serving a
        cached plan costs no search, and degrading it would force
        one)."""
        if level <= 0 or spec.alpha <= 0.0:
            return spec
        factor = self._slo_policy.alpha_factor(level)
        if factor >= 1.0:
            return spec
        if sess.plan_cached_for(spec):
            return spec
        return _dc_replace(spec, alpha=spec.alpha * factor)

    def _apply_slo_side_effects(self, level: int) -> None:
        sp = self._speculator
        if sp is not None and self._slo_policy is not None:
            sp.set_paused(level >= self._slo_policy.pause_speculation_at)

    # ------------------------------------------------------------------
    # worker loop
    # ------------------------------------------------------------------
    def _run(self, pool: _Pool, steal_ok: bool) -> None:
        while True:
            batch = pool.queue.drain(timeout=self._poll_s)
            if not batch and steal_ok and not self._stop.is_set():
                for other in self._pools_snapshot():
                    if other is pool:
                        continue
                    batch = other.queue.steal()
                    if batch:
                        break
            if batch:
                try:
                    self._execute(batch)
                except BaseException as exc:     # noqa: BLE001
                    # the worker must survive anything — a dead worker
                    # silently strands every queued and future query.
                    # Fail the batch's unresolved futures instead.
                    for it in batch:
                        _reject(it.future, exc)
                continue
            self._maybe_evict()
            if self._stop.is_set() and len(pool.queue) == 0:
                return

    def _group_key(self, spec: QuerySpec) -> Tuple[str, str]:
        # submit_many's batch-wide contracts: one trainer kind, one
        # execution backend.  α may vary inside a group — the session
        # auto-splits mixed-α batches into per-α Alg. 4 sub-batches.
        # spec.kind is already canonical (QuerySpec resolves aliases
        # like "gibbs" at construction), as is self.kind, so aliased
        # spellings of one kind land in one group.
        return (spec.kind or self.kind,
                spec.backend or self.backend.name)

    def _execute(self, batch: List[PendingQuery]) -> None:
        # named injection site for the chaos harness: a fault here
        # lands in the worker's catch-all, which must fail the batch's
        # futures and keep the thread alive (asserted in tests)
        maybe_fail("serve.worker")
        groups: Dict[Tuple[str, str], List[PendingQuery]] = {}
        for item in batch:
            groups.setdefault(self._group_key(item.spec), []).append(item)
        for (kind, backend_name), items in groups.items():
            self._execute_group(items, backend_name)

    def _admit(self, items: List[PendingQuery]) -> List[PendingQuery]:
        """Execution-start admission: expire deadlines and over-waited
        queries *before* burning capacity on them, and transition the
        survivors' futures PENDING → RUNNING exactly once (a future the
        client cancelled while queued is dropped here and can no longer
        be cancelled mid-execution, so set_result below can never race
        a cancellation into InvalidStateError)."""
        now = time.perf_counter()
        ready: List[PendingQuery] = []
        for it in items:
            if it.expired(now):
                if it.future.set_running_or_notify_cancel():
                    _reject(it.future, DeadlineExceededError(
                        f"deadline_s={it.options.deadline_s} elapsed "
                        f"before execution started"))
                    self._record_rejection(it, deadline=True)
            elif it.overwaited(now):
                if it.future.set_running_or_notify_cancel():
                    _reject(it.future, ShedError(
                        f"queued {now - it.enqueued_at:.3f}s, past "
                        f"max_queue_wait_s={it.options.max_queue_wait_s}"))
                    self._record_rejection(it, deadline=False)
            elif it.future.set_running_or_notify_cancel():
                ready.append(it)
        return ready

    def _record_rejection(self, item: PendingQuery, *,
                          deadline: bool) -> None:
        if deadline:
            self._m_deadline.inc()
        else:
            self._m_shed.inc()
        if item.trace_id and item.root_span_id:
            now = time.perf_counter()
            self.tracer.record(
                "serve.query", "serve", item.enqueued_at, now,
                trace_id=item.trace_id, span_id=item.root_span_id,
                attrs={"tenant": item.tenant,
                       "outcome": "deadline" if deadline else "shed"})
        with self._stats_lock:
            ts = self._tenants.get(item.tenant,
                                   TenantStats(tenant=item.tenant))
            self._tenants[item.tenant] = ts.bump(
                **({"deadline_rejected": 1} if deadline else {"shed": 1}))

    def _execute_group(self, items: List[PendingQuery],
                       backend_name: str) -> None:
        if not self._breaker_for(self._instance_for(backend_name)).allow():
            # breaker open: route the still-pending group to the
            # fallback pool instead of shedding — degraded answers
            # beat no answers.  With the whole chain open we fall
            # through and try the original backend anyway (strictly
            # no worse than rejecting).
            fb = self._reroute_target(backend_name)
            if fb is not None:
                pool = self._pool_for(self._instance_for(fb))
                self._m_reroutes.inc(len(items))
                for it in items:
                    it.spec = _dc_replace(it.spec, backend=fb)
                    if it.rerouted_from is None:
                        it.rerouted_from = backend_name
                    try:
                        pool.queue.put(it)
                    except (ShedError, ServiceClosedError) as exc:
                        if it.future.set_running_or_notify_cancel():
                            _reject(it.future, exc)
                            self._record_rejection(it, deadline=False)
                return
        items = self._admit(items)
        width = len(items)
        if width == 0:
            return
        level = self._degrade_level(backend_name)
        self._apply_slo_side_effects(level)
        with self._stats_lock:
            for it in items:
                self._inflight[it.tenant] = \
                    self._inflight.get(it.tenant, 0) + 1
        try:
            if width == 1:
                self._execute_serial(items, level)
                return
            # queue wait is measured to the group's own execution start
            # — a group stuck behind its batch-mates' execution is
            # still waiting, and the operator should see that time
            t0 = time.perf_counter()
            # every shared structure (store, plan cache, device LRU,
            # calibration) is common to all tenants, so any member's
            # session may host the execution; each shared gap segment
            # is trained on the stream of the first tenant (in sorted
            # order) covering it, so a tenant's results are
            # reproducible however its queries coalesced — group
            # membership and arrival order can't leak into another
            # tenant's RNG stream
            items.sort(key=lambda it: it.tenant)
            self._execute_fused(items, level, t0)
        finally:
            with self._stats_lock:
                for it in items:
                    n = self._inflight.get(it.tenant, 1) - 1
                    if n <= 0:
                        self._inflight.pop(it.tenant, None)
                    else:
                        self._inflight[it.tenant] = n

    def _execute_fused(self, items: List[PendingQuery], level: int,
                       t0: float) -> None:
        """Fused execution with bisecting failure isolation.

        A failed ``submit_many`` splits the group in half and retries
        each half fused, recursing down to width 1 (which runs through
        the serial path and surfaces the error on exactly the failing
        spec's future).  One malformed spec therefore costs O(log n)
        extra launches while every all-healthy half keeps its Alg. 4
        shared-segment training — the retired query-by-query fallback
        forfeited joint planning for the entire window."""
        width = len(items)
        if width == 1:
            self._execute_serial(items, level)
            return
        sessions = [self.session(it.tenant) for it in items]
        specs = [self._degrade_spec(it.spec, level, sessions[0])
                 for it in items]
        # one *group* span wraps the fused execution (its own trace);
        # each member query then gets a ``serve.execute`` child in its
        # *own* trace covering the same interval and cross-linked to
        # the group, so a coalesced query's trace id survives fusion
        t_ex0 = time.perf_counter()
        try:
            with self.tracer.span(
                    "serve.fuse", "serve",
                    attrs={"width": width,
                           "traces": ",".join(
                               it.trace_id or "?" for it in items)}) as gsp:
                br = sessions[0].submit_many(
                    specs, next_gens=[s._next_gen for s in sessions])
        except Exception:
            mid = width // 2
            self._m_bisect.inc()
            self._execute_fused(items[:mid], level, t0)
            self._execute_fused(items[mid:], level, t0)
            return
        t_ex1 = time.perf_counter()
        # breaker feed: already fired per report via the session's
        # outcome hook inside submit_many — nothing to do here
        self._m_groups.inc()
        self._m_coalesced.inc()
        with self._stats_lock:
            self._width_sum += width
            self._max_coalesce_width = max(self._max_coalesce_width,
                                           width)
        group_trace = gsp.trace_id if gsp is not None else ""
        for it, rep in zip(items, br.reports):
            rep.degraded = level
            if rep.fallback_from is None:
                rep.fallback_from = it.rerouted_from
            if it.trace_id:
                rep.trace = it.trace_id
                self.tracer.record(
                    "serve.execute", "serve", t_ex0, t_ex1,
                    trace_id=it.trace_id, parent_id=it.root_span_id,
                    attrs={"fused": True, "width": width,
                           "group_trace": group_trace,
                           "backend": br.backend or ""})
            self._record(it, t0, width, br.plan_cached,
                         model_ids=rep.model_ids, degraded=level)
            _resolve(it.future, rep)

    def _execute_serial(self, items: List[PendingQuery],
                        level: int = 0) -> None:
        """Width-1 groups and the failed-batch isolation retry.  The
        futures are already RUNNING (gated in ``_admit``)."""
        for it in items:
            t0 = time.perf_counter()     # this query's own start
            self._m_groups.inc()
            with self._stats_lock:
                self._width_sum += 1
                self._max_coalesce_width = max(self._max_coalesce_width, 1)
            sess = self.session(it.tenant)
            # breaker feed: the session's outcome hook fires inside
            # submit (success and failure), so the worker records only
            # stats/spans here
            try:
                with self.tracer.span(
                        "serve.execute", "serve",
                        trace_id=it.trace_id, parent_id=it.root_span_id,
                        attrs={"tenant": it.tenant, "fused": False}):
                    rep = sess.submit(
                        self._degrade_spec(it.spec, level, sess))
            except Exception as exc:
                self._record(it, t0, 1, False, error=True)
                _reject(it.future, exc)
            else:
                rep.degraded = level
                if rep.fallback_from is None:
                    rep.fallback_from = it.rerouted_from
                if it.trace_id:
                    rep.trace = it.trace_id
                self._record(it, t0, 1, rep.plan_cached,
                             model_ids=rep.model_ids, degraded=level)
                _resolve(it.future, rep)

    def _record(self, item: PendingQuery, t0: float, width: int,
                plan_cached: bool, error: bool = False,
                model_ids: Tuple[int, ...] = (),
                degraded: int = 0) -> None:
        now = time.perf_counter()
        wait = max(t0 - item.enqueued_at, 0.0)
        backend_name = item.spec.backend or self.backend.name
        self._m_queries.inc()
        if error:
            self._m_errors.inc()
        if degraded > 0 and not error:
            self._m_degraded.inc(level=str(degraded))
        if item.trace_id and item.root_span_id:
            # the per-query root and its queue-wait child are recorded
            # here, where both endpoints are known — they started on
            # the submitting thread, ended on this worker
            self.tracer.record(
                "queue.wait", "serve", item.enqueued_at, t0,
                trace_id=item.trace_id, parent_id=item.root_span_id,
                attrs={"pool": backend_name})
            self.tracer.record(
                "serve.query", "serve", item.enqueued_at, now,
                trace_id=item.trace_id, span_id=item.root_span_id,
                attrs={"tenant": item.tenant, "width": width,
                       "backend": backend_name, "error": error,
                       "degraded": degraded})
        with self._stats_lock:
            ts = self._tenants.get(item.tenant,
                                   TenantStats(tenant=item.tenant))
            self._tenants[item.tenant] = ts.absorb(
                wait_s=wait, width=width, plan_cached=plan_cached,
                error=error, degraded=degraded > 0 and not error)
        self._last_seen[item.tenant] = time.monotonic()
        if not error:
            # client-observed latency (enqueue → answer) feeds both the
            # SLO window and the exposition histogram of the backend
            # that served the query — one observe, one structure
            self._m_latency.observe(now - item.enqueued_at,
                                    backend=backend_name)
            spec = item.spec
            self._query_log.append(QueryLogEntry(
                tenant=item.tenant,
                sigma=tuple((s.lo, s.hi) for s in spec.sigma),
                kind=spec.kind or self.kind,
                alpha=spec.alpha, backend=spec.backend,
                t=time.monotonic()))
            spec_trainer = self._speculator
            if spec_trainer is not None and model_ids \
                    and spec_trainer.trained_ids.intersection(model_ids):
                spec_trainer.note_hit()

    def query_log(self) -> Tuple[QueryLogEntry, ...]:
        """Snapshot of the rolling answered-query log (speculator
        input; deque appends are thread-safe, tuple() snapshots)."""
        return tuple(self._query_log)

    # ------------------------------------------------------------------
    # streaming ingestion & speculation
    # ------------------------------------------------------------------
    def _install_corpus(self, corpus: Corpus) -> None:
        """Re-home every tenant session on a grown snapshot — called by
        the ingest pipeline *before* slice models land, so the planner
        can never cover a range whose tokens the index doesn't count."""
        with self._session_lock:
            self.corpus = corpus
            self._data_epoch += 1
            for sess in self._sessions.values():
                sess.extend_corpus(corpus)

    def attach_ingest(self, *, slice_width: float,
                      kind: Optional[str] = None,
                      compaction: Optional[CompactionPolicy] = None,
                      start: Optional[float] = None) -> IngestPipeline:
        """Wire streaming ingestion to this service (once).

        Returns the ``IngestPipeline``; feed it through ``ingest`` (or
        ``pipeline.append``).  With a ``CompactionPolicy`` the builder
        drives compaction/eviction after every built slice, keeping
        the managed kind's capital under the policy's byte budget.
        """
        if self._ingest is not None:
            raise RuntimeError("ingest pipeline already attached")
        if self._closed:
            raise ServiceClosedError("service is closed")
        kind = resolve_kind(kind or self.kind)
        compactor = Compactor(self.store, self.cfg, compaction,
                              kind=kind) if compaction is not None else None
        self._ingest = IngestPipeline(
            self.corpus, self.store, self.cfg,
            slice_width=slice_width, kind=kind, backend=self.backend,
            start=start, seed=self._tenant_seed("__ingest__"),
            on_corpus=self._install_corpus, compactor=compactor,
            device=self.device)
        return self._ingest

    def ingest(self, batch: Corpus) -> None:
        """Append one document batch to the attached pipeline."""
        if self._ingest is None:
            raise RuntimeError("no ingest pipeline: call attach_ingest "
                               "first")
        self._ingest.append(batch)

    def attach_speculator(self, *, window_s: float = 30.0,
                          min_count: int = 2, margin: float = 1.0,
                          poll_s: float = 0.05,
                          start: bool = True) -> SpeculativeTrainer:
        """Start workload-driven gap pre-training over the query log
        (once).  ``start=False`` skips the background thread — call
        ``scan_once`` manually (tests, benchmarks).  Under SLO
        degradation level ≥ ``pause_speculation_at`` the trainer is
        paused: overload capacity goes to answering, not pre-training.
        """
        if self._speculator is not None:
            raise RuntimeError("speculative trainer already attached")
        if self._closed:
            raise ServiceClosedError("service is closed")
        self._speculator = SpeculativeTrainer(
            self, window_s=window_s, min_count=min_count, margin=margin,
            poll_s=poll_s, start=start)
        return self._speculator

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def report(self) -> ServiceReport:
        cal = getattr(self.cost, "calibration", None)
        # per-backend SLO views off the shared latency histogram (one
        # entry per backend that has ever observed a sample)
        slo = {}
        for key in self._m_latency.series():
            name = key[0]
            tr = self._tracker(name)
            slo[name] = BackendSLO(
                p50_s=tr.p50, p95_s=tr.p95, p99_s=tr.p99,
                samples=len(tr),
                level=self._slo_policy.level(tr)
                if self._slo_policy is not None else 0)
        depth = {p.name: len(p.queue) for p in self._pools_snapshot()}
        with self._breaker_lock:
            blist = [(self._breaker_names[k], cb)
                     for k, cb in self._breakers.items()]
        # snapshot outside _breaker_lock: a cooled-down open breaker
        # transitions to half-open on observation, which fires the
        # quarantine-mirror hook
        breaker = {name: cb.snapshot() for name, cb in blist}
        with self._session_lock:
            active = len(self._sessions)
        # the JSON metrics snapshot reads the same registry objects the
        # counters below come from (running the mirror callbacks), so
        # exposition and report agree on a quiesced service
        metrics = self.registry.snapshot()
        with self._stats_lock:
            return ServiceReport(
                tenants=dict(self._tenants),
                queries=int(self._m_queries.total()),
                errors=int(self._m_errors.total()),
                groups=int(self._m_groups.total()),
                coalesced_groups=int(self._m_coalesced.total()),
                max_coalesce_width=self._max_coalesce_width,
                width_sum=self._width_sum,
                plan_cache_hits=self.plan_cache.hits,
                plan_cache_misses=self.plan_cache.misses,
                plan_cache_entries=len(self.plan_cache),
                backend=self.backend.stats,
                calibration_samples=len(cal) if cal is not None else 0,
                store_bytes=self.store.nbytes(),
                shed=int(self._m_shed.total()),
                deadline_rejected=int(self._m_deadline.total()),
                bisect_retries=int(self._m_bisect.total()),
                degraded_queries=int(self._m_degraded.total()),
                tenant_evictions=int(self._m_evictions.total()),
                active_sessions=active,
                queue_depth=depth,
                slo=slo,
                breaker=breaker,
                breaker_reroutes=int(self._m_reroutes.total()),
                retries=self.retry.snapshot(),
                metrics=metrics,
                ingest=self._ingest.report()
                if self._ingest is not None else None,
                speculation=self._speculator.report()
                if self._speculator is not None else None)


__all__ = ["DEFAULT_TENANT", "MLegoService"]
