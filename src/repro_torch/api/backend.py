"""Pluggable execution backends for the query hot path.

The Fig. 2 pipeline bottoms out in two data-plane operations: merging
a plan's materialized models (Alg. 1/2 — pure bandwidth) and training
scratch gaps (the VB E-step — pure arithmetic).  ``HostBackend`` merges
on host NumPy and is the parity reference; its trainers run on the
session's device, like the JAX package's host backend trains on JAX's
default device — on a CUDA session that is the E-step kernel too (the
registry's ``"vb"`` trainer calls ``vb_fit(..., use_kernel=True)``).
``DeviceBackend`` keeps hot model parameters resident
on a CUDA device in an LRU cache keyed by store model id (count- **and**
byte-bounded, invalidated through the store's change notifications),
executes merges through the hand-written ``merge_topics`` kernel — one
launch over the n cached parts per query, and one *ragged segmented* launch for a
``submit_many`` batch (zero pad rows) — and routes VB gap training
through the fused E-step kernel (``vb_fit(..., use_kernel=True)``) and
Gibbs gap training through the doc-blocked sweep kernel
(``cgs_fit_blocked``; the registry's ``"gs"`` trainer, which the host
backend uses, runs the exact-scan kernel on the card).  A
freshly trained persisted gap model is warm-inserted into the LRU
(``note_trained``) so the merge that follows reads it back as a hit.

``ShardedDeviceBackend`` ("device_sharded") lifts the one-device
memory ceiling: every cached model is resident as contiguous vocabulary
slices, one per device of the mesh's "model" axis; each shard merges
its slices with the same kernels, and only the per-topic row sums cross
shards (``distributed/merge_collective.py``).  Its byte accounting is
per device: an entry counts at the bytes of the device that holds most
of its slices.

``DeviceBackend.merge`` and ``merge_many`` hand the cached (K, V)
tensors to the kernel through a table of pointers, with no copy: a
batch's table lists every query's parts in order with the segments'
offsets (``merge_topics_parts_segments``), so the device holds the
resident capital and, for each merge in flight, its outputs alone.

Spans (``repro_torch.obs.trace``, no-ops outside a traced span): a
merge opens ``merge.fetch`` (the LRU gets, with a ``device.upload``
child per miss — a volatile gap model is always one — and, for a batch,
a ``merge.table`` child: the pointer table built and uploaded),
``kernel.launch`` (the launch call alone), ``merge.readback`` (β's copy
to the host, which waits for the launch) and ``merge.finish`` (the
family's numpy finish); a kernel-route gap opens ``train.readback``,
VB's also ``train.upload`` (the tokens) and ``train.layout`` (their CSR
built on the card), and the fits open ``train.fit`` (Gibbs'
``cgs_fit_blocked`` also its layout and uploads).  The ``*_device_ms``
of ``BackendStats`` are host wall times of those stages, not device
time.

No path here sends a CUDA tensor to a plain version: on a CUDA device a
kernel either launches or raises.  ``_device_guard`` maps out-of-memory
and CUDA runtime errors raised by torch to ``DeviceLostError`` (the
session replays on the fallback chain); a kernel build failure or a
nonzero launch status is a ``KernelError`` and fails the query.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, fields, replace
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.api.trainers import (
    TrainerFn,
    get_merge,
    get_trainer,
    merge_family_name,
)
from repro_torch.configs.lda_default import LDAConfig
from repro_torch.core.errors import DeviceLostError
from repro_torch.core.lda import MaterializedModel
from repro_torch.core.merge import (
    device_merge_params,
    device_norm_offset,
    device_stat_key,
)
from repro_torch.core.store import ModelStore
from repro_torch.data.corpus import Corpus
from repro_torch.distributed.merge_collective import (
    merge_topics_ragged_sharded,
    merge_topics_sharded,
    padded_vocab,
)
from repro_torch.distributed.sharding import MeshEnv, local_mesh_env
from repro_torch.kernels.common import KernelError, resolve_device
from repro_torch.kernels.merge_topics.ops import (
    merge_topics_parts,
    merge_topics_parts_segments,
    parts_table,
)
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import trace as obs
from repro_torch.testing.faults import maybe_fail

BACKEND_NAMES = ("host", "device", "device_sharded")

# Runtime errors torch raises when the card dies mid-launch (OOM, a
# faulted context, a failed transfer).  Translated to ``DeviceLostError``
# so callers can quarantine the backend and replay on the fallback chain.
_CUDA_ERRORS = tuple(
    t for t in (torch.cuda.OutOfMemoryError,
                getattr(torch, "AcceleratorError", None))
    if isinstance(t, type))


# a cache entry: one resident tensor, or a sharded cache's list of slices
Entry = Union[torch.Tensor, List[torch.Tensor]]


def _volatile(parts: Sequence[MaterializedModel]) -> int:
    """Parts with id −1: never in the store, so never cached: each
    fetch uploads them again."""
    return sum(1 for m in parts if m.model_id < 0)


def _is_cuda_runtime_error(exc: BaseException) -> bool:
    if isinstance(exc, _CUDA_ERRORS):
        return True
    return isinstance(exc, RuntimeError) and "CUDA error" in str(exc)


@dataclass(frozen=True)
class BackendStats:
    """Monotonic counters; diff two snapshots for per-query attribution.

    ``cache_resident_bytes`` is a *gauge* (current device-cache
    residency), not a counter — ``delta`` carries the newer snapshot's
    value through instead of differencing it.
    """

    cache_hits: int = 0
    cache_misses: int = 0
    cache_hit_bytes: int = 0          # bytes read from the device cache
    cache_miss_bytes: int = 0         # bytes transferred host->device
    cache_evictions: int = 0
    cache_invalidations: int = 0
    merges: int = 0
    merge_parts: int = 0              # parts (models) the merges read
    device_launches: int = 0
    host_fallbacks: int = 0
    merge_device_ms: float = 0.0      # host wall time: fetch, launch, copy
    pad_rows: int = 0                 # zero-weight rows in batched launches
    pad_bytes: int = 0                # bytes those zero-weight rows carry
    train_device_ms: float = 0.0      # kernel-route gap training, wall time
    gap_device_trains: int = 0        # gaps trained through a kernel route
    train_uploads: int = 0            # fresh gap models warmed into the LRU
    cache_resident_bytes: int = 0     # gauge: bytes resident right now

    _GAUGES = ("cache_resident_bytes",)

    def delta(self, since: "BackendStats") -> "BackendStats":
        return BackendStats(**{
            f.name: getattr(self, f.name) - (
                0 if f.name in self._GAUGES else getattr(since, f.name))
            for f in fields(self)})

    @property
    def hit_rate(self) -> float:
        seen = self.cache_hits + self.cache_misses
        return self.cache_hits / seen if seen else 0.0


class ExecutionBackend:
    """Interface the session/executor program against."""

    name: str = "?"
    shards: int = 1   # devices each cached model is sliced across

    def __init__(self):
        self.stats = BackendStats()
        self._stats_lock = threading.Lock()
        # Sessions attribute per-query work by diffing two stats
        # snapshots; on a *shared* backend a concurrent session's
        # launch landing inside that window would be mis-attributed.
        # Callers hold this around snapshot -> launch -> diff sections.
        self.measure_lock = threading.RLock()
        # health: a quarantined backend is suspected of device loss;
        # sessions route around it until a probe re-admits it
        self.quarantined = False

    # -- health ----------------------------------------------------------
    def quarantine(self) -> None:
        """Mark unhealthy (device lost).  Idempotent."""
        self.quarantined = True

    def unquarantine(self) -> None:
        """Re-admit after a successful health probe."""
        self.quarantined = False

    @contextmanager
    def _device_guard(self):
        """Translate raw runtime crashes into ``DeviceLostError`` so
        the caller knows the *backend* is suspect, not the query.  A
        ``KernelError`` passes through: a broken kernel fails the
        query instead of being replayed elsewhere."""
        try:
            yield
        except (DeviceLostError, KernelError):
            raise
        except RuntimeError as exc:
            if not _is_cuda_runtime_error(exc):
                raise
            raise DeviceLostError(
                f"{self.name} backend lost its device: {exc}",
                backend=self.name) from exc

    # -- lifecycle -------------------------------------------------------
    def bind_store(self, store: ModelStore) -> None:
        """Attach to the session's store (cache invalidation hookup)."""

    @property
    def bound_store(self) -> Optional[ModelStore]:
        """The store this backend caches against; None if stateless.

        Sessions refuse to adopt a backend whose ``bound_store`` is a
        *different* live store — the cache is keyed by model id alone,
        and ids from two stores collide silently."""
        return None

    # -- data plane ------------------------------------------------------
    def merge(self, parts: Sequence[MaterializedModel], kind: str,
              cfg: LDAConfig) -> np.ndarray:
        raise NotImplementedError

    def merge_many(self, part_lists: Sequence[Sequence[MaterializedModel]],
                   kind: str, cfg: LDAConfig) -> List[np.ndarray]:
        return [self.merge(p, kind, cfg) for p in part_lists]

    def trainer(self, kind: str) -> TrainerFn:
        return get_trainer(kind)

    def kernel_route(self, kind: str) -> bool:
        """True when ``trainer(kind)`` runs through a device kernel (the
        executor then attributes a trained gap's host wall time to
        ``train_device_ms`` per query)."""
        return False

    def note_trained(self, model: MaterializedModel) -> None:
        """Hook: a fresh gap model was persisted after training on this
        backend (device backends warm their LRU with it)."""

    # -- bookkeeping -----------------------------------------------------
    def _count(self, **kw) -> None:
        # read-modify-write on the immutable snapshot; locked so two
        # sessions sharing the backend can't lose each other's counts
        with self._stats_lock:
            self.stats = replace(
                self.stats, **{k: getattr(self.stats, k) + v
                               for k, v in kw.items()})


class HostBackend(ExecutionBackend):
    """NumPy merges — the parity reference for DeviceBackend.  Its
    trainers run on the device of the generator they are handed."""

    name = "host"

    def merge(self, parts, kind, cfg):
        maybe_fail("backend.merge.host")
        for _ in parts:
            maybe_fail("backend.fetch.host")
        self._count(merges=1, merge_parts=len(parts))
        return get_merge(kind)(list(parts), cfg)


class _DeviceModelCache:
    """LRU of device-resident merge statistics, keyed by store model id.

    Bounded two ways: ``capacity`` caps the entry count and
    ``max_bytes`` (optional) caps the resident parameter bytes — LRU
    entries are evicted until both bounds hold.  Volatile models (id −1,
    never in the store) pass through without being cached.

    Mutation is lock-serialized: one device cache may be shared by
    every session of a multi-tenant service over the same store.

    ``prepare`` maps a host statistic array to its resident form
    (default: one f32 tensor on ``device``); the sharded backend
    substitutes a pad-and-slice upload whose entry is a list of
    per-shard slices.  ``nbytes`` gives the bytes an entry is counted
    at in the bounds and counters (default: the tensor's bytes); the
    sharded backend counts an entry at the bytes of the device that
    holds most of its slices, so ``max_bytes`` bounds what any one
    device holds.
    """

    def __init__(self, capacity: int, max_bytes: Optional[int] = None,
                 *, device: Union[str, torch.device] = "cuda",
                 prepare=None, nbytes=None):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.capacity = capacity
        self.max_bytes = max_bytes
        self.device = torch.device(device)
        self._prepare = prepare or self._upload
        self._nb = nbytes or self._tensor_bytes
        self._entries: "OrderedDict[int, Entry]" = OrderedDict()
        self._lock = threading.RLock()
        self.resident_bytes = 0
        self.hits = self.misses = self.evictions = self.invalidations = 0
        self.hit_bytes = self.miss_bytes = 0
        # residency epoch: bumps whenever the resident *set* changes
        # (insert/evict/invalidate/clear) — the session plan cache keys
        # on it for providers that price fetches by cache state
        self.epoch = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, model_id: int) -> bool:
        return model_id in self._entries

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        return host.to(self.device)

    def _over_budget(self) -> bool:
        return (len(self._entries) > self.capacity
                or (self.max_bytes is not None
                    and self.resident_bytes > self.max_bytes))

    @staticmethod
    def _tensor_bytes(arr: torch.Tensor) -> int:
        return arr.numel() * arr.element_size()

    def _evict_lru(self) -> None:
        mid, arr = self._entries.popitem(last=False)
        self.resident_bytes -= self._nb(arr)
        self.evictions += 1
        self.epoch += 1
        obs.instant("cache.evict", model_id=mid, bytes=self._nb(arr))

    def _fits_alone(self, arr: Entry) -> bool:
        """A model bigger than the whole byte budget must pass through
        uncached — inserting it would evict every resident entry
        before LRU order finally evicted the newcomer itself."""
        return self.max_bytes is None or self._nb(arr) <= self.max_bytes

    def get(self, model: MaterializedModel, stat_key: str) -> Entry:
        mid = model.model_id
        with self._lock:
            if mid >= 0 and mid in self._entries:
                self.hits += 1
                self.hit_bytes += self._nb(self._entries[mid])
                self._entries.move_to_end(mid)
                return self._entries[mid]
            self.misses += 1
            with obs.span("device.upload", "backend", model_id=mid):
                arr = self._prepare(model.theta[stat_key])
                obs.set_attrs(bytes=self._nb(arr))
            self.miss_bytes += self._nb(arr)
            if mid >= 0 and self._fits_alone(arr):
                self._entries[mid] = arr
                self.resident_bytes += self._nb(arr)
                self.epoch += 1
                while self._entries and self._over_budget():
                    self._evict_lru()
            return arr

    def put(self, model: MaterializedModel, stat_key: str) -> bool:
        """Warm-insert a model (no hit/miss accounting) — the gap-
        training upload path.  Returns True if it ended up resident
        (an over-budget model passes through uncached)."""
        mid = model.model_id
        with self._lock:
            if mid < 0 or mid in self._entries:
                return mid in self._entries
            with obs.span("device.upload", "backend", model_id=mid,
                          warm=True):
                arr = self._prepare(model.theta[stat_key])
                obs.set_attrs(bytes=self._nb(arr))
            if not self._fits_alone(arr):
                return False
            self._entries[mid] = arr
            self.resident_bytes += self._nb(arr)
            self.epoch += 1
            while self._entries and self._over_budget():
                self._evict_lru()
            return mid in self._entries

    def invalidate(self, model_id: int) -> None:
        with self._lock:
            arr = self._entries.pop(model_id, None)
            if arr is not None:
                self.resident_bytes -= self._nb(arr)
                self.invalidations += 1
                self.epoch += 1

    def clear(self) -> None:
        with self._lock:
            if self._entries:
                self.epoch += 1
            self._entries.clear()
            self.resident_bytes = 0


class DeviceBackend(ExecutionBackend):
    """Device-resident merges + kernel gap training (VB E-step, Gibbs
    sweep).

    capacity  : max cached models (LRU-evicted beyond it)
    max_bytes : optional cap on resident parameter bytes (evicts LRU
                until under; a model larger than the cap passes
                through uncached)
    device    : the CUDA device (default "cuda"; "cpu" runs the same
                code path with each kernel's plain version, for tests)
    gibbs_block_docs : documents per sampler block on the "gs" route
                (more blocks = shorter sequential chain, slightly
                staler topic-word counts within a sweep).  Kept for
                parity with ``repro.api.DeviceBackend``; every route
                still runs the blocked kernel, whatever its value
    profile   : wrap each launch in a profiler range (``mlego.*``;
                ``obs.profile.annotate``) and land the single merge's
                flops/bytes on its ``kernel.launch`` span as
                ``kernel_*`` attributes (off by default)

    "vb" gaps train through the fused E-step kernel and "gs" gaps
    through the doc-blocked sweep kernel (``cgs_fit_blocked``, which is
    statistically — not bit — equivalent to the exact scan the host
    backend runs); every other kind uses the trainer registry.  Fresh
    gap models are *warm-inserted* into the LRU (``note_trained``),
    tracked in ``stats.train_uploads``.
    """

    name = "device"

    def __init__(self, capacity: int = 64, *,
                 max_bytes: Optional[int] = None,
                 device: Union[str, torch.device, None] = None,
                 gibbs_block_docs: int = 64,
                 profile: bool = False):
        super().__init__()
        if gibbs_block_docs < 1:
            raise ValueError(f"gibbs_block_docs must be >= 1, got "
                             f"{gibbs_block_docs}")
        self.device = resolve_device(device)
        self.gibbs_block_docs = gibbs_block_docs
        self.profile = profile
        self.cache = self._make_cache(capacity, max_bytes)
        self._store: Optional[ModelStore] = None

    def _make_cache(self, capacity: int,
                    max_bytes: Optional[int]) -> _DeviceModelCache:
        return _DeviceModelCache(capacity, max_bytes, device=self.device)

    # -- lifecycle -------------------------------------------------------
    def bind_store(self, store: ModelStore) -> None:
        if store is self._store:
            return
        if self._store is not None:
            self._store.unsubscribe(self._on_store_event)
        self._store = store
        self.cache.clear()
        store.subscribe(self._on_store_event)

    @property
    def bound_store(self) -> Optional[ModelStore]:
        return self._store

    def _on_store_event(self, event: str, model_id: int) -> None:
        # "remove" drops stale device copies; "add" defends against id
        # collisions from a store that was swapped or reloaded in place.
        self.cache.invalidate(model_id)
        self._sync_cache_counters()

    def quarantine(self) -> None:
        # resident copies on a lost device are garbage; drop them so a
        # re-admitted backend re-uploads from the store
        super().quarantine()
        self.cache.clear()
        self._sync_cache_counters()

    def _fetch(self, model, stat_key: str) -> Entry:
        maybe_fail(f"backend.fetch.{self.name}")
        return self.cache.get(model, stat_key)

    def _annotate(self, name: str):
        """Profiler range for a launch; no-op unless profiling."""
        return obs_profile.annotate(name, self.device) if self.profile \
            else nullcontext()

    # -- merge -----------------------------------------------------------
    def merge(self, parts, kind, cfg):
        maybe_fail(f"backend.merge.{self.name}")
        fam = merge_family_name(kind)
        if fam is None:                  # custom merge callable: host only
            self._count(merges=1, merge_parts=len(parts), host_fallbacks=1)
            return get_merge(kind)(list(parts), cfg)
        stat_key, bias, base, finish = device_merge_params(fam, cfg)
        t0 = time.perf_counter()
        with self._device_guard():
            with obs.span("merge.fetch", "backend", n_parts=len(parts),
                          stacked_bytes=0, volatile=_volatile(parts)):
                # the cached tensors go to the kernel as they are: no
                # stacked copy, and the unit weights go by value
                stats = [self._fetch(m, stat_key) for m in parts]
            with self._annotate("mlego.merge_topics"):
                with obs.span("kernel.launch", "backend", op="merge_topics",
                              n_parts=len(parts), backend=self.name):
                    merged = merge_topics_parts(stats, [1.0] * len(parts),
                                                bias=bias, base=base)
                    if self.profile:
                        obs_profile.annotate_span(
                            "kernel", obs_profile.merge_features(
                                len(stats), *stats[0].shape))
                with obs.span("merge.readback", "backend",
                              bytes=merged.numel() * merged.element_size()):
                    host = merged.cpu().numpy()  # waits for the launch
        ms = (time.perf_counter() - t0) * 1e3
        self._sync_cache_counters()
        self._count(merges=1, merge_parts=len(parts), device_launches=1,
                    merge_device_ms=ms)
        with obs.span("merge.finish", "backend", rows=1):
            return finish(host)

    def merge_many(self, part_lists, kind, cfg):
        """§V.C batch merge stage: one ragged segmented launch.

        Every query's parts are read where the LRU holds them, through
        one pointer table with the segments' offsets: no stacked or
        concatenated copy (``stacked_bytes`` 0), zero pad rows on any
        batch shape (``stats.pad_rows`` stays 0)."""
        fam = merge_family_name(kind)
        if fam is None:
            # per-list self.merge counts the merges and fallbacks
            return super().merge_many(part_lists, kind, cfg)
        if len(part_lists) == 1:
            return [self.merge(part_lists[0], kind, cfg)]
        maybe_fail(f"backend.merge.{self.name}")
        stat_key, bias, base, finish = device_merge_params(fam, cfg)
        counts = [len(parts) for parts in part_lists]
        t0 = time.perf_counter()
        with self._device_guard():
            with obs.span("merge.fetch", "backend", n_parts=sum(counts),
                          stacked_bytes=0,
                          volatile=sum(_volatile(p) for p in part_lists)):
                stats = [self._fetch(m, stat_key)
                         for parts in part_lists for m in parts]
                with obs.span("merge.table", "backend", n_parts=len(stats),
                              segments=len(counts)):
                    table = parts_table(stats, counts)
            with self._annotate("mlego.merge_topics_ragged"):
                with obs.span("kernel.launch", "backend",
                              op="merge_topics_ragged",
                              n_plans=len(part_lists), backend=self.name,
                              pad_rows=0):
                    merged = merge_topics_parts_segments(
                        stats, counts, bias=bias, base=base, table=table)
                with obs.span("merge.readback", "backend",
                              bytes=merged.numel() * merged.element_size()):
                    # a row at a time: rows below the allocator's mmap
                    # threshold reuse freed host memory; one (n, K, V)
                    # copy page-faults a fresh mapping every batch
                    host = [row.cpu().numpy() for row in merged]
        ms = (time.perf_counter() - t0) * 1e3
        self._sync_cache_counters()
        self._count(merges=len(part_lists), merge_parts=len(stats),
                    device_launches=1, merge_device_ms=ms)
        with obs.span("merge.finish", "backend", rows=len(host)):
            return [finish(row) for row in host]

    def _sync_cache_counters(self) -> None:
        c = self.cache
        with self._stats_lock:
            self.stats = replace(self.stats, cache_hits=c.hits,
                                 cache_misses=c.misses,
                                 cache_hit_bytes=c.hit_bytes,
                                 cache_miss_bytes=c.miss_bytes,
                                 cache_evictions=c.evictions,
                                 cache_invalidations=c.invalidations,
                                 cache_resident_bytes=c.resident_bytes)

    # -- training --------------------------------------------------------
    def trainer(self, kind: str) -> TrainerFn:
        if kind == "vb":
            return self._train_vb_kernel
        if kind == "gs":
            return self._train_gs_kernel
        return get_trainer(kind)

    def kernel_route(self, kind: str) -> bool:
        return kind in ("vb", "gs")

    def note_trained(self, model: MaterializedModel) -> None:
        fam = merge_family_name(model.kind)
        if fam is None:                  # custom merge: no device form
            return
        if self.cache.put(model, device_stat_key(fam)):
            self._count(train_uploads=1)
        self._sync_cache_counters()

    def _check_generator(self, gen: torch.Generator) -> None:
        if gen.device != self.device:
            raise ValueError(f"generator on {gen.device}, backend on "
                             f"{self.device}")

    def _train_vb_kernel(self, corpus: Corpus, cfg: LDAConfig,
                         gen: torch.Generator) -> Dict[str, np.ndarray]:
        """The gap's tokens go to the card and its CSR is built there:
        the E-step reads only the nonzeros, so no dense (D, V) matrix is
        made on either side."""
        from repro_torch.core.vb import vb_fit
        from repro_torch.kernels.vb_estep.ops import doc_term_csr_from_tokens
        self._check_generator(gen)
        t0 = time.perf_counter()
        with self._device_guard(), self._annotate("mlego.vb_estep"):
            host = [np.ascontiguousarray(a, np.int32)
                    for a in (corpus.doc_ids, corpus.tokens)]
            with obs.span("train.upload", "train",
                          bytes=sum(a.nbytes for a in host)):
                doc_ids, tokens = (torch.from_numpy(a).to(self.device)
                                   for a in host)
            with obs.span("train.layout", "train", tokens=corpus.n_tokens,
                          docs=corpus.n_docs):
                csr = doc_term_csr_from_tokens(doc_ids, tokens,
                                               corpus.n_docs,
                                               corpus.vocab_size)
                obs.set_attrs(nnz=csr.nnz, max_row=csr.max_row)
            lam = vb_fit(csr, gen, cfg, use_kernel=True)
            with obs.span("train.readback", "train",
                          bytes=lam.numel() * lam.element_size()):
                lam = lam.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        obs.set_attrs(route="vb_estep")
        self._count(gap_device_trains=1, train_device_ms=ms)
        return {"lam": lam}

    def _train_gs_kernel(self, corpus: Corpus, cfg: LDAConfig,
                         gen: torch.Generator,
                         global_nkv: Optional[np.ndarray] = None
                         ) -> Dict[str, np.ndarray]:
        from repro_torch.core.gibbs import cgs_fit_blocked
        self._check_generator(gen)
        t0 = time.perf_counter()
        with self._device_guard(), self._annotate("mlego.gibbs_sweep"):
            nkv = cgs_fit_blocked(corpus.tokens, corpus.doc_ids, cfg, gen,
                                  global_nkv=global_nkv,
                                  block_docs=self.gibbs_block_docs)
            with obs.span("train.readback", "train",
                          bytes=nkv.numel() * nkv.element_size()):
                nkv = nkv.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        obs.set_attrs(route="gibbs_blocked")
        self._count(gap_device_trains=1, train_device_ms=ms)
        return {"delta_nkv": nkv}


class ShardedDeviceBackend(DeviceBackend):
    """Vocab-sharded merges: each model shard owns a ``Vp/shards`` slice.

    The cache uploads every model statistic as contiguous ``(K,
    Vp/shards)`` slices, one on each device of the mesh's "model" axis
    (``Vp = padded_vocab(V, shards)``; pad columns are masked out of the
    row sums, so their value never matters); an entry is the model's
    list of slices.  Merges run through ``distributed/merge_collective``:
    every shard merges its slices with the merge kernels by pointer
    table (one ``merge_topics_parts`` launch a query, one
    ``merge_topics_parts_segments`` launch a batch: the kernel modules
    count one launch per shard),
    applies the family's finisher offset, and joins the (K,) row sums —
    the *only* cross-shard traffic, added in shard order on the first
    device.  β therefore comes back normalised and the host finisher is
    bypassed.  ``stats.device_launches`` counts 1 a merge call, as the
    JAX package's one ``shard_map`` launch does.

    ``max_bytes`` bounds **per-device** residency: an entry counts at
    the bytes of the device that holds most of its slices.  On a grid of
    distinct devices that is its padded bytes / shards, so a model stack
    whose f32 bytes exceed one device's budget stays resident; on a grid
    that names one device for every shard it is the whole padded model,
    as it is in that device's memory.  (The JAX package divides by the
    shard count: its mesh never repeats a device.)  ``env``
    defaults to ``local_mesh_env(device)``, a (1, n) grid over every
    local card (one shard on a one-card host: the unsharded semantics);
    a grid may name one device several times.  Only data row 0 of the
    grid holds slices (the JAX package replicates the model list over
    the data axis).  Gap training is inherited unchanged and runs on the
    grid's first device: ``"vb"`` gaps on the E-step kernel, ``"gs"``
    gaps on the blocked sweep; trained models are warm-inserted as
    slices.
    """

    name = "device_sharded"

    def __init__(self, capacity: int = 64, *,
                 max_bytes: Optional[int] = None,
                 device: Union[str, torch.device, None] = None,
                 env: Optional[MeshEnv] = None,
                 gibbs_block_docs: int = 64,
                 profile: bool = False):
        self.env = env if env is not None else local_mesh_env(device)
        if device is not None and resolve_device(device) != self.env.first:
            raise ValueError(f"device {device} is not the mesh's first "
                             f"device {self.env.first}")
        self.shards = self.env.tp_size
        super().__init__(capacity, max_bytes=max_bytes,
                         device=self.env.first,
                         gibbs_block_docs=gibbs_block_docs, profile=profile)

    def _make_cache(self, capacity, max_bytes):
        return _DeviceModelCache(capacity, max_bytes, device=self.device,
                                 prepare=self._prepare_stat,
                                 nbytes=self._entry_bytes)

    def _entry_bytes(self, slices: List[torch.Tensor]) -> int:
        """The bytes of an entry's slices on its most-loaded device."""
        per_device: Dict[torch.device, int] = {}
        for dev, t in zip(self.env.devices[0], slices):
            per_device[dev] = (per_device.get(dev, 0)
                               + t.numel() * t.element_size())
        return max(per_device.values())

    def _prepare_stat(self, arr: np.ndarray) -> List[torch.Tensor]:
        """Pad V with zeros to ``padded_vocab`` and upload one contiguous
        (K, Vp/shards) slice to each shard's device."""
        x = np.asarray(arr, np.float32)
        vs = padded_vocab(x.shape[-1], self.shards) // self.shards
        out = []
        for s, dev in enumerate(self.env.devices[0]):
            piece = np.zeros((x.shape[0], vs), np.float32)
            cols = x[:, s * vs:(s + 1) * vs]
            piece[:, :cols.shape[1]] = cols
            out.append(torch.from_numpy(piece).to(dev))
        return out

    # -- merge -----------------------------------------------------------
    def merge(self, parts, kind, cfg):
        maybe_fail(f"backend.merge.{self.name}")
        fam = merge_family_name(kind)
        if fam is None:                  # custom merge callable: host only
            self._count(merges=1, host_fallbacks=1)
            return get_merge(kind)(list(parts), cfg)
        stat_key, bias, base, _ = device_merge_params(fam, cfg)
        v_true = int(parts[0].theta[stat_key].shape[-1])
        t0 = time.perf_counter()
        with self._device_guard(), \
                obs.span("kernel.launch", "backend",
                         op="merge_topics_sharded", n_parts=len(parts),
                         backend=self.name, shards=self.shards):
            entries = [self._fetch(m, stat_key) for m in parts]
            with self._annotate("mlego.merge_topics_sharded"):
                beta = merge_topics_sharded(
                    [[e[s] for e in entries] for s in range(self.shards)],
                    [1.0] * len(parts), self.env, bias=bias, base=base,
                    num_offset=device_norm_offset(fam, cfg), v_true=v_true)
                host = self._allgather(beta)     # waits for the launches
            ms = (time.perf_counter() - t0) * 1e3
        self._sync_cache_counters()
        self._count(merges=1, merge_parts=len(parts), device_launches=1,
                    merge_device_ms=ms)
        return host[:, :v_true]

    def merge_many(self, part_lists, kind, cfg):
        """§V.C batch merge stage: one ragged segmented launch a shard."""
        fam = merge_family_name(kind)
        if fam is None:
            return ExecutionBackend.merge_many(self, part_lists, kind, cfg)
        if len(part_lists) == 1:
            return [self.merge(part_lists[0], kind, cfg)]
        maybe_fail(f"backend.merge.{self.name}")
        stat_key, bias, base, _ = device_merge_params(fam, cfg)
        v_true = int(part_lists[0][0].theta[stat_key].shape[-1])
        counts = [len(parts) for parts in part_lists]
        t0 = time.perf_counter()
        with self._device_guard(), \
                obs.span("kernel.launch", "backend",
                         op="merge_topics_ragged_sharded",
                         n_plans=len(part_lists), backend=self.name,
                         shards=self.shards):
            entries = [self._fetch(m, stat_key)
                       for parts in part_lists for m in parts]
            with self._annotate("mlego.merge_topics_ragged_sharded"):
                beta = merge_topics_ragged_sharded(
                    [[e[s] for e in entries] for s in range(self.shards)],
                    [1.0] * len(entries), counts, self.env, bias=bias,
                    base=base, num_offset=device_norm_offset(fam, cfg),
                    v_true=v_true)
                host = self._allgather(beta)     # waits for the launches
            ms = (time.perf_counter() - t0) * 1e3
        self._sync_cache_counters()
        self._count(merges=len(part_lists), merge_parts=len(entries),
                    device_launches=1, merge_device_ms=ms)
        return [host[i, :, :v_true] for i in range(len(counts))]

    def _allgather(self, beta: List[torch.Tensor]) -> np.ndarray:
        """Copy every shard's β slice to the host, joined along V.  Each
        copy waits for the work queued before it on its device's current
        stream, which holds this merge's launches."""
        with obs.span("allgather", "backend", backend=self.name,
                      bytes=sum(b.numel() * 4 for b in beta),
                      shards=self.shards):
            return torch.cat([b.cpu() for b in beta], dim=-1).numpy()


_FACTORIES = {"host": HostBackend, "device": DeviceBackend,
              "device_sharded": ShardedDeviceBackend}


def make_backend(name: str, **kwargs) -> ExecutionBackend:
    """Construct a backend by name; ``kwargs`` pass to its constructor
    (host ignores ``device=`` — it merges on the host, and its trainers
    run on the device of the generator they are handed — and
    ``profile=``: it has no launches to annotate)."""
    try:
        factory = _FACTORIES[name]
    except KeyError:
        raise ValueError(f"unknown execution backend {name!r}; one of "
                         f"{BACKEND_NAMES}") from None
    if factory is HostBackend:
        kwargs.pop("device", None)
        kwargs.pop("profile", None)
    return factory(**kwargs)
