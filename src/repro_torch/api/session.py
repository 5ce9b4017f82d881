"""``MLegoSession`` — the canonical entry point to MLego.

The session owns the Def. 1 members that are *not* per-query: the
dataset D (corpus + range index), the analysis function F (LDAConfig +
default trainer kind), the materialized-model store, the plan cost
provider, the RNG state, and the execution backend.  Queries arrive as
typed ``QuerySpec``s through a single ``submit`` path:

    session = MLegoSession(corpus, cfg)
    report  = session.submit(QuerySpec(sigma=Interval(0, 500), alpha=0.5))
    batch   = session.submit_many([spec1, spec2, spec3])

``submit`` runs the Fig. 2 pipeline per predicate component (plan
search -> gap training -> merge); union-of-intervals predicates are
planned per component and merged into one model.  Each component's
search goes through the session **plan cache** first: a repeated query
against an unchanged store (same σ, α, kind, method, backend, prices)
skips the search stage entirely (``QueryReport.plan_cached``); any
store mutation invalidates the cache through ``ModelStore.subscribe``.

``submit_many`` runs the §V.C Alg. 4 batch path: the batch is
reordered for joint planning (widest query first), every shared gap
segment is trained exactly once, the merge stage launches as
one ragged segmented kernel (zero pad rows), and the shared search/train costs are
reported at the batch level (``BatchReport``), not on the first query.

Plan search prices plans through a pluggable cost provider
(``cost="analytic"`` — the paper's Eq. 2 model — or
``cost="calibrated"``, which refits κ/t_m from this session's measured
timings and prices device-cache hits/misses and batch padding; see
``repro_torch.core.cost``).  The data plane (merge + gap training) executes
on a pluggable backend: ``backend="host"`` (default) merges on NumPy;
``"device"`` keeps hot model parameters resident on the card and
merges through the CUDA ``merge_topics`` kernel.  A ``QuerySpec.backend``
overrides the session default per query.

The session runs on ``device`` ("cuda" unless the caller asks for the
CPU; asking for CUDA where torch sees none raises).  Its random stream
is a locked CPU ``torch.Generator`` seeded from ``seed``; every training
call gets a child generator on the session's device, seeded from the
next draw of that stream.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, List, Optional, Sequence, Union

import torch

from repro_torch.api.backend import DeviceBackend, ExecutionBackend, make_backend
from repro_torch.api.executor import Executor, StalePlanError
from repro_torch.core.errors import DeviceLostError, RetryPolicy
from repro_torch.obs import trace as obs
from repro_torch.obs.trace import Tracer
from repro_torch.api.planner import PlanCache, Planner
from repro_torch.api.reports import BatchReport, QueryReport
from repro_torch.api.spec import QuerySpec
from repro_torch.api.trainers import resolve_kind
from repro_torch.configs.lda_default import LDAConfig
from repro_torch.core.batch_opt import BatchResult, _segments
from repro_torch.core.cost import (
    CalibratedCostModel,
    Calibration,
    CostModel,
    CostProvider,
)
from repro_torch.core.lda import MaterializedModel
from repro_torch.core.plans import Interval
from repro_torch.core.search import SearchResult
from repro_torch.core.store import ModelStore
from repro_torch.data.corpus import Corpus, DataIndex
from repro_torch.kernels.common import resolve_device

# distinct from the JAX package's "calibration.json": timings taken on a
# CUDA card and on a TPU never mix over one store directory
CALIBRATION_SIDECAR = "calibration_cuda.json"


def calibration_sidecar(store_path: str) -> str:
    """Path of the calibration JSON sidecar for a store directory."""
    return os.path.join(store_path, CALIBRATION_SIDECAR)


def _store_size_probe(store: ModelStore):
    """Byte-size probe closed over one store (None for unknown ids) —
    homed on the store, not a session, so a session's later store swap
    cannot silently re-aim a probe other sessions price through."""
    def probe(model_id: int) -> Optional[int]:
        try:
            return store.get(model_id).nbytes()
        except KeyError:
            return None
    return probe


class MLegoSession:
    """One corpus + one model store + one RNG stream; many queries."""

    def __init__(self, corpus: Corpus, cfg: LDAConfig, *,
                 store: Optional[ModelStore] = None,
                 cost: Union[CostProvider, str, None] = None,
                 kind: str = "vb", seed: int = 0,
                 backend: Union[str, ExecutionBackend] = "host",
                 plan_cache: Optional[PlanCache] = None,
                 plan_cache_entries: int = 256,
                 calibration_path: Optional[str] = None,
                 retry: Optional[RetryPolicy] = None,
                 tracer: Optional[Tracer] = None,
                 device: Union[str, torch.device, None] = "cuda",
                 profile: bool = False):
        self.device = resolve_device(device)
        self._profile = profile
        self.corpus = corpus
        self.index = DataIndex(corpus)
        self._backends = {}
        store = store if store is not None else ModelStore()
        # an externally-owned plan cache (the serving layer's shared
        # cache) must already be homed on this session's store — keys
        # are value-addressed, but adopting a cache that invalidates
        # over a *different* store would clear it out from under its
        # other sessions on the bind below
        if plan_cache is not None and plan_cache.store is not None \
                and plan_cache.store is not store:
            raise ValueError(
                "plan_cache is bound to a different store; a shared "
                "plan cache requires the sharing sessions to share the "
                "store it invalidates over")
        self._owns_plan_cache = plan_cache is None
        self._adopted_backends = set()   # backend *instances* handed in
        self._plan_cache = plan_cache if plan_cache is not None \
            else PlanCache(max_entries=plan_cache_entries)
        self.store = store
        self.cfg = cfg
        self.calibration_path = calibration_path
        # provider *instances* may be shared across sessions (the
        # serving layer's one calibration log); string/None selections
        # construct a private provider this session may re-home freely
        self._owns_cost = cost is None or isinstance(cost, str)
        self.cost = self._make_cost(cost, cfg, calibration_path)
        self._wire_cost_probes()
        self.kind = resolve_kind(kind)       # default backend for train_range
        self._gen = torch.Generator().manual_seed(seed)
        self._gen_lock = threading.Lock()
        # bumped by extend_corpus: plans priced under an older corpus
        # snapshot counted fewer tokens per range, so cached entries
        # keyed on an older epoch are never served (capital aging —
        # the store fingerprint alone can't see corpus growth)
        self._data_epoch = 0
        self.planner = Planner(self.index, self.cost)
        # one retry policy for every data-plane call; shared with the
        # serving layer when it constructs tenant sessions
        self.retry = retry if retry is not None else RetryPolicy()
        self.executor = Executor(corpus, cfg, self.store, self._next_gen,
                                 retry=self.retry)
        # tracing: every submit/submit_many opens a root span on this
        # tracer; a private tracer by default, or the serving layer's
        # shared one (so worker-thread spans from many tenant sessions
        # land in one exportable buffer)
        self.tracer = tracer if tracer is not None else Tracer()
        # optional outcome hook: called once per answered query with
        # (answered_by_backend, fallback_from, error) — the serving
        # layer installs its breaker/health feed here so *direct*
        # session use (tenants bypassing the front door) still counts
        self.on_outcome: Optional[
            Callable[[str, Optional[str], Optional[BaseException]],
                     None]] = None
        self.backend = self._register_backend(
            make_backend(backend, device=self.device, profile=profile)
            if isinstance(backend, str) else backend,
            adopted=not isinstance(backend, str))

    @staticmethod
    def _make_cost(cost: Union[CostProvider, str, None],
                   cfg: LDAConfig,
                   calibration_path: Optional[str] = None) -> CostProvider:
        base = CostModel(max_iters=cfg.max_iters, n_topics=cfg.n_topics)
        if cost is None or cost == "analytic":
            if calibration_path is not None:
                # silently ignoring the sidecar would leave the session
                # at analytic prices while the caller believes it
                # warm-started
                raise ValueError(
                    "calibration_path requires cost='calibrated' (or a "
                    "CalibratedCostModel instance); the analytic "
                    "provider has nothing to load it into")
            return base
        if cost == "calibrated":
            provider = CalibratedCostModel(base)
            if calibration_path:
                provider.load_calibration(calibration_path)
            return provider
        if isinstance(cost, str):
            raise ValueError(f"unknown cost provider {cost!r}; "
                             f"one of ('analytic', 'calibrated') or a "
                             f"CostProvider instance")
        if calibration_path is not None:
            if not isinstance(cost, CalibratedCostModel):
                raise ValueError(
                    "calibration_path requires cost='calibrated' (or a "
                    f"CalibratedCostModel instance), got {cost!r}")
            if len(cost.calibration) == 0:
                cost.load_calibration(calibration_path)
        return cost

    def _wire_cost_probes(self) -> None:
        """Point a calibrated provider's byte-size probe at the store
        (fetch terms are per-byte) and seed the part-size hint from the
        config's (K, V) f32 shape.  The probe is homed on the *store*
        (not this session), so sharing the provider requires sharing
        that store — model ids collide across stores, and a foreign
        probe would silently mis-size every fetch."""
        if getattr(self.cost, "size_probe", False) is None:
            self.cost.size_probe = _store_size_probe(self.store)
            self.cost._size_probe_store = self.store
        else:
            wired = getattr(self.cost, "_size_probe_store", None)
            if wired is not None and wired is not self.store:
                raise ValueError(
                    "cost provider's size probe is wired to a different "
                    "store; share a calibrated provider only between "
                    "sessions that share one store")
        if getattr(self.cost, "part_bytes_hint", False) is None:
            self.cost.part_bytes_hint = float(
                self.cfg.n_topics * self.cfg.vocab_size * 4)

    def save_calibration(self, path: Optional[str] = None) -> str:
        """Persist the calibrated provider's measurement log as the
        store's JSON sidecar (versioned) — the next
        ``MLegoSession(cost="calibrated", calibration_path=...)`` over
        this store starts at today's prices instead of the analytic
        cold start.  Returns the path written."""
        path = path or self.calibration_path
        if path is None:
            raise ValueError("no calibration path: pass one here or set "
                             "calibration_path= on the session")
        cal = getattr(self.cost, "calibration", None)
        if cal is None:
            raise ValueError("session's cost provider is not calibrated; "
                             "nothing to persist")
        cal.save(path)
        return path

    # ------------------------------------------------------------------
    @property
    def store(self) -> ModelStore:
        return self._store

    @store.setter
    def store(self, v: ModelStore) -> None:
        # Swapping the store (the legacy-shim path) must re-home every
        # backend cache — stale subscriptions would miss invalidations —
        # and the plan cache, whose entries reference the old model set.
        # Shared resources are the exception: an *adopted* backend may
        # serve other sessions over the old store, so rebinding it here
        # would silently break them — the caller must re-home it
        # explicitly (backend.bind_store) before the swap; a shared
        # plan cache is simply left behind (still homed on the old
        # store, still serving its other sessions) and replaced with a
        # fresh private one.
        for name, b in self._backends.items():
            if name in getattr(self, "_adopted_backends", ()) \
                    and b.bound_store is not None and b.bound_store is not v:
                raise ValueError(
                    "cannot swap the store under an adopted execution "
                    "backend (it may be shared by other sessions over "
                    "the old store); call backend.bind_store(new_store) "
                    "first if the backend really is private")
        probe_store = getattr(getattr(self, "cost", None),
                              "_size_probe_store", None)
        if probe_store is not None and probe_store is not v:
            if getattr(self, "_owns_cost", True):
                # private provider: re-home its byte-size probe
                self.cost.size_probe = _store_size_probe(v)
                self.cost._size_probe_store = v
            else:
                raise ValueError(
                    "cannot swap the store under a shared cost provider "
                    "(its size probe prices fetches against the old "
                    "store, which other sessions may still use)")
        self._store = v
        for b in self._backends.values():
            b.bind_store(v)
        if getattr(self, "_owns_plan_cache", True) \
                or self._plan_cache.store is None \
                or self._plan_cache.store is v:
            # private cache, or shared cache being adopted/kept on its
            # home store: (re)bind — no-op when already homed on v
            self._plan_cache.bind_store(v)
        else:
            # swapping away from a shared cache's home store: leave it
            # behind (still serving its other sessions) and continue
            # with a fresh private cache on the new store
            self._plan_cache = PlanCache(
                max_entries=self._plan_cache.max_entries)
            self._plan_cache.bind_store(v)
            self._owns_plan_cache = True
        if hasattr(self, "executor"):       # unset during __init__
            self.executor.store = v

    @property
    def plan_cache(self) -> PlanCache:
        return self._plan_cache

    def _next_gen(self) -> torch.Generator:
        # locked: a service tenant may build capital on its own thread
        # while the worker loop executes the same session — an unlocked
        # draw here could hand both threads the same seed (duplicate
        # RNG streams, silently correlated samples)
        with self._gen_lock:
            seed = int(torch.randint(0, 2 ** 62, (), generator=self._gen))
        return torch.Generator(device=self.device).manual_seed(seed)

    def extend_corpus(self, corpus: Corpus) -> None:
        """Install a grown corpus snapshot (streaming ingestion).

        Growth is append-only: the new snapshot must contain at least
        the old one's documents (the ingest pipeline only ever
        concatenates).  The range index, planner and executor are
        re-homed on the new snapshot, and the data epoch bumps so
        cached plans priced under the old token counts are dropped —
        a query over a freshly ingested range must re-plan, not ride a
        cached plan that believed the range was empty.
        """
        if corpus.vocab_size != self.corpus.vocab_size:
            raise ValueError(
                f"extend_corpus: vocab mismatch ({corpus.vocab_size} vs "
                f"{self.corpus.vocab_size})")
        if corpus.n_docs < self.corpus.n_docs:
            raise ValueError(
                "extend_corpus is append-only: the new snapshot has "
                f"{corpus.n_docs} docs, fewer than the current "
                f"{self.corpus.n_docs}")
        index = DataIndex(corpus)
        self.corpus = corpus
        self.index = index
        self.planner.index = index
        self.executor.corpus = corpus
        self._data_epoch += 1

    def adopt_backend(self, inst: ExecutionBackend) -> ExecutionBackend:
        """Register a shared execution backend instance under its name,
        so specs naming that backend route to it instead of a fresh
        private instance — the serving layer's per-name routing."""
        return self._register_backend(inst, adopted=True)

    def _register_backend(self, inst: ExecutionBackend,
                          adopted: bool = False) -> ExecutionBackend:
        bound = inst.bound_store
        if adopted:
            self._adopted_backends.add(inst.name)
        if bound is not None and bound is not self.store:
            # sharing one backend across sessions is supported *over
            # one shared store* (the serving layer's device LRU); two
            # different stores both allocate model id 0, so a shared
            # cache would silently cross-serve parameters
            raise ValueError(
                "execution backend is already bound to a different "
                "store; its device cache is keyed by model id and ids "
                "collide across stores — share a backend only between "
                "sessions that share one store (one backend per session "
                "otherwise)")
        inst.bind_store(self.store)
        self._backends[inst.name] = inst
        # a calibrated provider prices fetches by device-cache state;
        # point its probe at the device backend's LRU once one exists
        if (isinstance(inst, DeviceBackend)
                and getattr(self.cost, "cache_probe", False) is None):
            self.cost.cache_probe = lambda mid: mid in inst.cache
        # a sharded backend observes *per-shard* bytes; tell the
        # provider so fetch prices use the same unit the fit is in
        shards = getattr(self.cost, "backend_shards", None)
        if shards is not None and inst.shards > 1:
            shards[inst.name] = inst.shards
        return inst

    def _backend_for(self, spec: QuerySpec) -> ExecutionBackend:
        """Spec's backend (session default when unset), one instance per
        name so device caches survive across queries."""
        if spec.backend is None:
            return self.backend
        if spec.backend not in self._backends:
            self._register_backend(
                make_backend(spec.backend, device=self.device,
                             profile=self._profile))
        return self._backends[spec.backend]

    # device-loss fallback chain: sharded -> single-device -> host
    # (host is terminal: it cannot lose a device)
    _FALLBACK = {"device_sharded": "device", "device": "host"}

    def _fail_over(self, backend: ExecutionBackend
                   ) -> Optional[ExecutionBackend]:
        """Quarantine a device-lost backend and return the next healthy
        backend on the fallback chain (None when the chain is
        exhausted or the backend has no fallback).  The quarantined
        backend stays registered — a breaker's half-open probe (or an
        explicit ``unquarantine``) re-admits it."""
        backend.quarantine()
        name = backend.name
        while True:
            name = self._FALLBACK.get(name)
            if name is None:
                return None
            if name not in self._backends:
                self._register_backend(
                    make_backend(name, device=self.device,
                                 profile=self._profile))
            nxt = self._backends[name]
            if not nxt.quarantined:
                obs.instant("fallback", from_backend=backend.name,
                            to_backend=nxt.name)
                return nxt

    def _models(self, kind: str) -> List[MaterializedModel]:
        """Store models of ``kind``, matching alias tags too — stores
        persisted by the legacy engine may carry e.g. "gibbs" verbatim."""
        out = []
        for m in self.store.models():
            try:
                mk = resolve_kind(m.kind)
            except ValueError:
                mk = m.kind
            if mk == kind:
                out.append(m)
        return out

    def train_range(self, lo: float, hi: float,
                    kind: Optional[str] = None) -> Optional[MaterializedModel]:
        """Materialize one model on [lo, hi) (offline capital building)."""
        return self.executor.train_gap(lo, hi, kind or self.kind,
                                       persist=True, backend=self.backend)

    # ------------------------------------------------------------------
    def _component_key(self, sigma: Interval, spec: QuerySpec, kind: str,
                       backend: ExecutionBackend, fingerprint: int) -> tuple:
        # a calibrated provider prices fetches by device-LRU residency
        # (cache_probe), so residency churn must key the cache too —
        # otherwise a cached plan could be served at stale fetch prices
        return (sigma.lo, sigma.hi, spec.alpha, kind, spec.method,
                backend.name, fingerprint, self.cost,
                getattr(self.cost, "version", 0),
                self._cache_epoch(backend), self._data_epoch)

    def plan_cached_for(self, spec: QuerySpec) -> bool:
        """True when every component of ``spec`` already has a cached
        plan — i.e. answering it costs no search.  Non-counting and
        non-promoting (``PlanCache.peek``): the serving layer's SLO
        degradation loop probes this to decide whether degrading α
        would actually save anything."""
        kind = spec.kind or self.kind
        backend = self._backend_for(spec)
        fingerprint = PlanCache.fingerprint(self._models(kind))
        return all(
            self._plan_cache.peek(self._component_key(
                sigma, spec, kind, backend, fingerprint)) is not None
            for sigma in spec.sigma)

    def _plan_component(self, models, fingerprint: int, sigma: Interval,
                        spec: QuerySpec, kind: str,
                        backend: ExecutionBackend
                        ) -> tuple:
        """(SearchResult, was_cached) for one predicate component."""
        key = self._component_key(sigma, spec, kind, backend, fingerprint)
        cached = self._plan_cache.get(key)
        if cached is not None:
            return cached, True
        # κ is backend-keyed: gap training must be priced at the rate
        # of the backend that will actually run it
        self.cost.set_train_backend(backend.name)
        res = self.planner.plan(models, sigma, spec.alpha, spec.method)
        self._plan_cache.put(key, res)
        return res, False

    def _cache_epoch(self, backend: ExecutionBackend) -> int:
        if getattr(self.cost, "cache_probe", None) is not None \
                and isinstance(backend, DeviceBackend):
            return backend.cache.epoch
        return 0

    def _observe_merge(self, n_merges: int, merge_s: float, d,
                       backend: str = "device") -> None:
        """Feed measured merge timings to the cost provider (fetch and
        pad terms are per-byte, read off the backend's traffic
        counters).  ``backend`` names which device backend's fit the
        samples feed — the sharded backend's counters are per-shard
        bytes, which must never mix into the unsharded fit."""
        if d.merge_device_ms > 0.0:
            secs = d.merge_device_ms * 1e-3
            traffic = d.cache_hit_bytes + d.cache_miss_bytes + d.pad_bytes
            if d.pad_bytes > 0 and traffic > 0:
                # apportion the launch by bytes: the pad share is the
                # *marginal* time the zero-weight rows cost, the rest
                # stays attributed to the real fetches below
                pad_secs = secs * d.pad_bytes / traffic
                self.cost.observe_pad(d.pad_bytes, pad_secs,
                                      backend=backend)
                secs -= pad_secs
            self.cost.observe_merge_device(d.cache_hit_bytes,
                                           d.cache_miss_bytes, secs,
                                           backend=backend)
        elif n_merges > 0:
            self.cost.observe_merge_host(n_merges, merge_s)

    def _emit_outcome(self, answered_by: str,
                      fallback_from: Optional[str],
                      error: Optional[BaseException]) -> None:
        """Fire the outcome hook, never letting observer errors mask
        the query's own result."""
        if self.on_outcome is None:
            return
        try:
            self.on_outcome(answered_by, fallback_from, error)
        except Exception:
            pass

    def submit(self, spec: QuerySpec) -> QueryReport:
        """One analytic query: plan search, gap training, merge.

        ``spec.kind=None`` (the default) uses the session's kind;
        ``spec.backend=None`` the session's execution backend.

        The whole query runs under a ``session.submit`` root span on
        ``self.tracer``; the returned report carries its ``trace`` id,
        so the query's plan/fetch/train/merge breakdown can be looked
        up in the exported Chrome trace.
        """
        with self.tracer.span(
                "session.submit", "session",
                attrs={"sigma": str(spec.sigma), "alpha": spec.alpha,
                       "kind": spec.kind or self.kind}) as root:
            try:
                rep = self._submit_traced(spec)
            except BaseException as exc:
                self._emit_outcome(spec.backend or self.backend.name,
                                   None, exc)
                raise
        if root is not None and rep.trace is None:
            rep.trace = root.trace_id
        self._emit_outcome(rep.backend, rep.fallback_from, None)
        return rep

    def _submit_traced(self, spec: QuerySpec) -> QueryReport:
        """``submit`` body; runs under the root span opened above."""
        kind = spec.kind or self.kind
        backend = self._backend_for(spec)
        plans: List[SearchResult] = []
        fresh: List[MaterializedModel] = []
        parts: List[MaterializedModel] = []
        n_tok = 0
        search_s = train_s = 0.0
        all_cached = True
        fallback_from: Optional[str] = None
        models = self._models(kind)
        fingerprint = PlanCache.fingerprint(models)
        train_device_ms = 0.0
        for sigma in spec.sigma:
            stale_left = 1
            while True:
                t0 = time.perf_counter()
                with obs.span("plan", "session", lo=sigma.lo, hi=sigma.hi):
                    res, was_cached = self._plan_component(
                        models, fingerprint, sigma, spec, kind, backend)
                    obs.set_attrs(cached=was_cached)
                search_s += time.perf_counter() - t0

                # training below may mutate the store (persisted gap
                # models), dropping earlier cache entries; this
                # component's entry is keyed on the snapshot
                # fingerprint its search actually saw, so it can never
                # be served for a different model set
                t1 = time.perf_counter()
                try:
                    c_parts, c_fresh, c_tok, samples = self.executor.gather(
                        res.ir, kind, persist=spec.persist, backend=backend)
                except StalePlanError:
                    # background compaction/eviction removed a planned
                    # model between search and fetch; the mutation
                    # already cleared the plan cache, so one re-plan
                    # over the current snapshot suffices
                    train_s += time.perf_counter() - t1
                    if not stale_left:
                        raise
                    stale_left -= 1
                    models = self._models(kind)
                    fingerprint = PlanCache.fingerprint(models)
                    continue
                except DeviceLostError:
                    # the backend is suspect, not the query: quarantine
                    # it and replay this component on the fallback
                    # chain.  Segments the failed attempt persisted
                    # remain capital and re-enter the re-plan as
                    # fetchable models; plans are backend-keyed, so the
                    # fallback's prices drive a fresh search.
                    train_s += time.perf_counter() - t1
                    nxt = self._fail_over(backend)
                    if nxt is None:
                        raise
                    if fallback_from is None:
                        fallback_from = backend.name
                    backend = nxt
                    models = self._models(kind)
                    fingerprint = PlanCache.fingerprint(models)
                    continue
                train_s += time.perf_counter() - t1
                break
            all_cached &= was_cached
            plans.append(res)
            parts.extend(c_parts)
            fresh.extend(c_fresh)
            n_tok += c_tok
            # device seconds come per-sample from the executor (nonzero
            # only when the backend kernel-routed that gap), so a
            # query's device attribution is *its own* — concurrent
            # sessions sharing the backend no longer leak their train
            # launches into this query's counter the way the old
            # stats-snapshot diff did
            for tok, secs, dev_s in samples:
                self.cost.observe_train(tok, secs, backend=backend.name)
                train_device_ms += dev_s * 1e3

        if not parts:
            raise ValueError(f"query {spec.sigma} selects no data")
        # the snapshot->merge->diff window is held against concurrent
        # sessions sharing this backend: their launches inside it
        # would corrupt this query's counters and the per-byte
        # calibration samples derived from them
        while True:
            try:
                with backend.measure_lock:
                    snap = backend.stats
                    t2 = time.perf_counter()
                    beta = self.executor.merge(parts, backend=backend)
                    merge_s = time.perf_counter() - t2
                    d = backend.stats.delta(snap)
                break
            except DeviceLostError:
                # parts are host-side models — the fallback backend can
                # merge them directly, no re-plan needed at this stage
                nxt = self._fail_over(backend)
                if nxt is None:
                    raise
                if fallback_from is None:
                    fallback_from = backend.name
                backend = nxt
        self._observe_merge(len(parts) - 1, merge_s, d,
                            backend=backend.name)
        return QueryReport(beta, spec, tuple(plans), n_tok, len(parts),
                           train_s, merge_s, search_s, materialized=fresh,
                           backend=backend.name,
                           merge_device_ms=d.merge_device_ms,
                           train_device_ms=train_device_ms,
                           cache_hits=d.cache_hits,
                           cache_misses=d.cache_misses,
                           cache_resident_bytes=d.cache_resident_bytes,
                           plan_cached=all_cached,
                           fallback_from=fallback_from)

    # ------------------------------------------------------------------
    def submit_many(self, specs: Sequence[QuerySpec], *,
                    next_gens: Optional[
                        Sequence[Callable[[], torch.Generator]]] = None
                    ) -> BatchReport:
        """§V.C batch path: Alg. 4 plan combination, shared gap training.

        All specs must use one trainer kind (shared segments are merged
        into every covering query, so their Θ must be homogeneous) and
        one execution backend (the merge stage launches as one ragged
        segmented kernel).  The joint optimization runs
        under one α (it seeds every query's initial plan); a mixed-α
        batch is *auto-split* into per-α sub-batches — each planned and
        trained jointly on its own, reports re-interleaved into
        submission order (no gap sharing happens *across* α groups).
        Union predicates are supported: each component interval enters
        the joint optimization as its own range, and the owning query
        merges parts from all its components.

        A uniform-α batch consults the session plan cache first: the
        whole Alg. 4 result is memoized under the batch's spec
        fingerprints + store fingerprint, so a repeated identical batch
        over an unchanged store skips the joint search entirely
        (``BatchReport.plan_cached``).

        The batch is *reordered* for joint planning — Alg. 4 visits the
        widest query first so the shared-segment structure is anchored
        before narrow queries prune against it — but reports stay
        parallel to the submitted spec order.  ``spec.method`` is not
        consulted (Alg. 4 supersedes per-query search).

        ``next_gens`` (parallel to ``specs``) supplies a per-query
        generator callable; each shared gap segment is trained with the
        stream of the first (lowest-index) query covering it.  The
        serving layer passes tenant streams here so a coalesced group
        reproduces per-tenant; ``None`` keeps this session's stream.

        The batch runs under one ``session.submit_many`` root span;
        the ``BatchReport`` (and any per-query report that does not
        already carry one) gets its ``trace`` id.
        """
        with self.tracer.span(
                "session.submit_many", "session",
                attrs={"batch": len(specs)}) as root:
            try:
                rep = self._submit_many_inner(list(specs), next_gens)
            except BaseException as exc:
                name = self.backend.name
                for s in specs:
                    self._emit_outcome(s.backend or name, None, exc)
                raise
        if root is not None:
            if rep.trace is None:
                rep.trace = root.trace_id
            for r in rep.reports:
                if r.trace is None:
                    r.trace = root.trace_id
        for r in rep.reports:
            self._emit_outcome(r.backend, r.fallback_from, None)
        return rep

    def _submit_many_inner(self, specs: List[QuerySpec],
                           next_gens: Optional[
                               Sequence[Callable[[], torch.Generator]]] = None
                           ) -> BatchReport:
        """``submit_many`` body (also the α-split recursion target, so
        sub-batches do not re-open root spans or re-fire outcomes)."""
        if next_gens is not None and len(next_gens) != len(specs):
            raise ValueError(
                f"next_gens must parallel specs: got {len(next_gens)} "
                f"keys for {len(specs)} specs")
        if not specs:
            return BatchReport([], self.planner.plan_batch([], []), 0.0, 0.0)
        alphas = {s.alpha for s in specs}
        if len(alphas) != 1:
            return self._submit_many_split(specs, next_gens)
        alpha = alphas.pop()
        kinds = {s.kind or self.kind for s in specs}
        if len(kinds) != 1:
            raise ValueError(f"submit_many requires one backend kind per "
                             f"batch, got {sorted(kinds)}")
        kind = kinds.pop()
        backends = {self._backend_for(s) for s in specs}
        if len(backends) != 1:
            raise ValueError(
                f"submit_many requires one execution backend per batch, "
                f"got {sorted(b.name for b in backends)}")
        backend = backends.pop()

        # flatten union predicates: one planning range per component
        owner: List[int] = []
        sigmas: List[Interval] = []
        for i, s in enumerate(specs):
            for sigma in s.sigma:
                owner.append(i)
                sigmas.append(sigma)

        # like single-spec submit, the batch path retries StalePlanError
        # once: background compaction/eviction can remove a planned
        # model between the joint search and the assembly fetch, and
        # the mutation already cleared the plan cache — so one in-place
        # re-plan over the current snapshot answers the batch without
        # surfacing the transient to callers (the serving layer's
        # serial fallback stays reserved for real per-spec failures).
        # Device loss mid-batch quarantines the backend and replays the
        # whole batch on the fallback chain.  In both cases, segments
        # the failed attempt persisted remain as capital and enter the
        # re-plan as fetchable models.
        stale_left = 1
        fallback_from: Optional[str] = None
        while True:
            try:
                rep = self._submit_many_once(specs, sigmas, owner, alpha,
                                             kind, backend, next_gens)
            except StalePlanError:
                if not stale_left:
                    raise
                stale_left -= 1
                continue
            except DeviceLostError:
                nxt = self._fail_over(backend)
                if nxt is None:
                    raise
                if fallback_from is None:
                    fallback_from = backend.name
                backend = nxt
                continue
            if fallback_from is not None:
                rep.fallback_from = fallback_from
                for r in rep.reports:
                    r.fallback_from = fallback_from
            return rep

    def _submit_many_once(self, specs: List[QuerySpec],
                          sigmas: List[Interval], owner: List[int],
                          alpha: float, kind: str,
                          backend: ExecutionBackend,
                          next_gens: Optional[
                              Sequence[Callable[[], torch.Generator]]]
                          ) -> BatchReport:
        """One attempt of the Alg. 4 batch path (see ``submit_many``)."""
        # batch-level plan cache: repeated identical batches over an
        # unchanged store (same specs, prices, residency) skip Alg. 4
        models = self._models(kind)
        bkey = ("batch",
                tuple((s.lo, s.hi) for s in sigmas), tuple(owner),
                alpha, kind, backend.name, PlanCache.fingerprint(models),
                self.cost, getattr(self.cost, "version", 0),
                self._cache_epoch(backend), self._data_epoch)
        t0 = time.perf_counter()
        with obs.span("plan", "session", batch=len(specs),
                      components=len(sigmas)):
            opt = self._plan_cache.get(bkey)
            batch_cached = opt is not None
            if opt is None:
                self.cost.set_train_backend(backend.name)
                opt = self.planner.plan_batch(models, sigmas, alpha)
                self._plan_cache.put(bkey, opt)
            obs.set_attrs(cached=batch_cached)
        shared_search_s = time.perf_counter() - t0

        # train every atomic shared gap segment exactly once (gap
        # structure read off the lowered Plan IR)
        gap_lists = [[g.gap for g in ir.gaps] for ir in opt.irs]
        seg_models = {}
        # per-segment wall time counts as device time iff this backend
        # routes the kind through a kernel — attribution stays with
        # *this batch's* segments even when other sessions share the
        # backend concurrently
        kernel_route = backend.kernel_route(kind)
        train_device_ms = 0.0
        t1 = time.perf_counter()
        for lo, hi, _ in _segments(gap_lists):
            covering = sorted({
                owner[j] for j, gaps in enumerate(gap_lists)
                if any(g.lo <= lo and hi <= g.hi for g in gaps)})
            persist = any(specs[i].persist for i in covering)
            # a shared segment is trained once, on the *first* covering
            # query's stream — deterministic in submission order, so
            # callers that pre-sort (the serving layer sorts by tenant)
            # get reproducible per-tenant results
            gen_fn = next_gens[covering[0]] \
                if next_gens is not None and covering else None
            t_gap = time.perf_counter()
            m = self.executor.train_gap(lo, hi, kind, persist=persist,
                                        backend=backend, next_gen=gen_fn)
            if m is not None:
                dt = time.perf_counter() - t_gap
                seg_models[(lo, hi)] = m
                self.cost.observe_train(m.n_tokens, dt,
                                        backend=backend.name)
                if kernel_route:
                    train_device_ms += dt * 1e3
        shared_train_s = time.perf_counter() - t1

        # assemble every query's part list from its components' IR
        # (fetches resolved by id), then merge the whole batch through
        # one backend call — a single ragged segmented device launch
        part_lists: List[List[MaterializedModel]] = []
        plans_per_q: List[List[SearchResult]] = []
        ntok_per_q: List[int] = []
        gather_s: List[float] = []
        for i, spec in enumerate(specs):
            t2 = time.perf_counter()
            parts: List[MaterializedModel] = []
            plans: List[SearchResult] = []
            n_tok = 0
            for j, (own, ir) in enumerate(zip(owner, opt.irs)):
                if own != i:
                    continue
                plans.append(SearchResult(opt.plans[j], 0.0, alpha,
                                          method="ALG4", ir=ir))
                try:
                    parts.extend(self.store.get(f.model_id)
                                 for f in ir.fetches)
                except KeyError as exc:
                    # a planned model vanished between search and
                    # assembly (background compaction/eviction) — typed
                    # so submit_many's retry loop re-plans in place
                    raise StalePlanError(
                        f"model {exc.args[0]!r} vanished between batch "
                        f"planning and assembly") from exc
                for (lo, hi), m in seg_models.items():
                    if any(g.lo <= lo and hi <= g.hi
                           for g in gap_lists[j]):
                        parts.append(m)
                        n_tok += m.n_tokens
            if not parts:
                raise ValueError(f"query {spec.sigma} selects no data")
            part_lists.append(parts)
            plans_per_q.append(plans)
            ntok_per_q.append(n_tok)
            gather_s.append(time.perf_counter() - t2)

        with backend.measure_lock:
            snap = backend.stats
            t3 = time.perf_counter()
            betas = self.executor.merge_many(part_lists, backend=backend)
            batch_merge_s = time.perf_counter() - t3
            d = backend.stats.delta(snap)
        launch_share = batch_merge_s / len(specs)
        self._observe_merge(sum(max(len(p) - 1, 0) for p in part_lists),
                            batch_merge_s, d, backend=backend.name)

        reports = [
            QueryReport(beta, spec, tuple(plans), n_tok, len(parts),
                        0.0, gather + launch_share, 0.0,
                        backend=backend.name)
            for beta, spec, plans, n_tok, parts, gather in zip(
                betas, specs, plans_per_q, ntok_per_q, part_lists, gather_s)]
        return BatchReport(reports, opt, shared_search_s, shared_train_s,
                           materialized=list(seg_models.values()),
                           backend=backend.name,
                           merge_device_ms=d.merge_device_ms,
                           train_device_ms=train_device_ms,
                           cache_hits=d.cache_hits,
                           cache_misses=d.cache_misses,
                           cache_resident_bytes=d.cache_resident_bytes,
                           pad_rows=d.pad_rows,
                           plan_cached=batch_cached)

    def _submit_many_split(self, specs: List[QuerySpec],
                           next_gens: Optional[
                               Sequence[Callable[[], torch.Generator]]] = None
                           ) -> BatchReport:
        """Mixed-α batch: one Alg. 4 sub-batch per α, reports stitched
        back into submission order.  Gap segments are shared *within*
        each α group only — queries under different α chose their
        plans under different accuracy/latency preferences, so their
        joint pruning is not comparable."""
        # kind/backend uniformity is a *batch-wide* contract — validate
        # before splitting so a mixed batch fails the same way whether
        # or not its α values happen to coincide
        kinds = {s.kind or self.kind for s in specs}
        if len(kinds) != 1:
            raise ValueError(f"submit_many requires one backend kind per "
                             f"batch, got {sorted(kinds)}")
        if len({self._backend_for(s) for s in specs}) != 1:
            raise ValueError(
                "submit_many requires one execution backend per batch")
        groups: "dict[float, List[int]]" = {}
        for i, s in enumerate(specs):
            groups.setdefault(s.alpha, []).append(i)
        reports: List[Optional[QueryReport]] = [None] * len(specs)
        subs: List[BatchReport] = []
        for idxs in groups.values():
            sub = self._submit_many_inner(
                [specs[i] for i in idxs],
                next_gens=[next_gens[i] for i in idxs]
                if next_gens is not None else None)
            subs.append(sub)
            for i, rep in zip(idxs, sub.reports):
                reports[i] = rep
        opt = BatchResult(
            plans=[], total_time=sum(s.opt.total_time for s in subs),
            naive_time=sum(s.opt.naive_time for s in subs),
            benefit=sum(s.opt.benefit for s in subs),
            n_scored=sum(s.opt.n_scored for s in subs),
            elapsed_s=sum(s.opt.elapsed_s for s in subs),
            method="ALG4/alpha-split")
        return BatchReport(
            reports, opt,
            shared_search_s=sum(s.shared_search_s for s in subs),
            shared_train_s=sum(s.shared_train_s for s in subs),
            materialized=[m for s in subs for m in s.materialized],
            backend=subs[0].backend,
            merge_device_ms=sum(s.merge_device_ms for s in subs),
            train_device_ms=sum(s.train_device_ms for s in subs),
            cache_hits=sum(s.cache_hits for s in subs),
            cache_misses=sum(s.cache_misses for s in subs),
            cache_resident_bytes=subs[-1].cache_resident_bytes,
            pad_rows=sum(s.pad_rows for s in subs),
            plan_cached=all(s.plan_cached for s in subs),
            fallback_from=next(
                (s.fallback_from for s in subs
                 if s.fallback_from is not None), None))
