"""Streaming ingestion — append-only document batches into reuse capital.

The paper's store is built offline; ``IngestPipeline`` keeps it fresh
against a moving corpus.  Batches append through ``append`` (the
producer thread), land in the growing corpus snapshot immediately
(``on_corpus`` lets the serving layer re-home tenant sessions before
any model materializes — queries over not-yet-built slices simply gap
train from the raw documents), and are bucketed into fixed-width time
slices on the attr axis.  A slice *closes* when the ingest frontier
passes its upper bound — append-only means no later batch can add to
it — and the background **builder thread** then trains its base model
via the trainer registry and materializes it into the shared
``ModelStore``.  That ``store.add`` rides the normal subscribe
channel, so plan caches and device LRUs invalidate exactly as they do
for manual saves, and the next query over the slice fetches capital
instead of retraining.

Ordering invariant: the corpus snapshot always grows *before* a slice
model lands.  The reverse window (model in the store, docs missing
from the session index) would let the planner cover a range with a
model whose tokens the index counts as zero — an empty-looking plan.

After each built slice the pipeline drives its ``Compactor`` (if
configured), so the capital stays under its byte budget as it grows.

Slices train on the pipeline's ``device`` ("cuda" unless the caller asks
for the CPU; a ``DeviceBackend`` lends its own device): every slice gets
a child ``torch.Generator`` on that device, seeded from the next draw of
a locked CPU stream seeded from ``seed``, so on a CUDA pipeline a slice
reaches the E-step or sweep kernel and never the plain version.
"""
from __future__ import annotations

import math
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple, Union

import torch

from repro_torch.api.backend import DeviceBackend, ExecutionBackend
from repro_torch.api.trainers import get_trainer, resolve_kind
from repro_torch.configs.lda_default import LDAConfig
from repro_torch.core.plans import Interval
from repro_torch.core.store import ModelStore
from repro_torch.data.corpus import Corpus, concat_corpora
from repro_torch.ingest.compaction import Compactor
from repro_torch.kernels.common import resolve_device


@dataclass(frozen=True)
class IngestReport:
    """Point-in-time snapshot of the pipeline."""

    batches: int = 0
    docs: int = 0
    tokens: int = 0
    slices_built: int = 0            # slice models materialized
    slices_pending: int = 0          # closed, waiting on the builder
    slices_empty: int = 0            # closed with no documents
    build_errors: int = 0
    frontier: float = 0.0            # max attr ingested so far
    # freshness lag: slice close -> model materialized, seconds
    freshness_lag_s_last: float = 0.0
    freshness_lag_s_mean: float = 0.0
    freshness_lag_s_max: float = 0.0
    # compaction (zero unless a compactor is attached)
    compactions: int = 0
    evictions: int = 0
    store_bytes: int = 0


class IngestPipeline:
    """One growing corpus, one builder thread, one managed kind.

    corpus      : the base snapshot ingestion grows from; its attr
                  frontier is where streaming may begin
    store       : shared ``ModelStore`` slice models materialize into
    cfg         : trainer config (one F for the whole stream)
    slice_width : attr width of one time slice
    kind        : trainer kind for slice base models
    backend     : execution backend whose registry-resolved trainer
                  runs the slice fits and whose device cache is warmed
                  (``note_trained``) per built slice; None = host
                  registry trainer, no warm-insert
    start       : first slice boundary (defaults to the next
                  ``slice_width`` multiple at/above the base frontier);
                  batches below it are rejected — they would overlap
                  capital the base store may already hold
    on_corpus   : called with every grown snapshot *before* the batch's
                  slices can close (the serving layer re-homes tenant
                  sessions here)
    compactor   : optional ``Compactor`` driven after each built slice
    device      : where slices train ("cuda" unless given; asking for
                  CUDA without a card raises); with a ``DeviceBackend``
                  the backend's device, whatever is passed here
    """

    def __init__(self, corpus: Corpus, store: ModelStore, cfg: LDAConfig, *,
                 slice_width: float, kind: str = "vb",
                 backend: Optional[ExecutionBackend] = None,
                 start: Optional[float] = None, seed: int = 0,
                 on_corpus: Optional[Callable[[Corpus], None]] = None,
                 compactor: Optional[Compactor] = None,
                 device: Union[str, torch.device, None] = "cuda"):
        if slice_width <= 0:
            raise ValueError("slice_width must be positive")
        self.store = store
        self.cfg = cfg
        self.slice_width = float(slice_width)
        self.kind = resolve_kind(kind)
        self.backend = backend
        self.device = backend.device if isinstance(backend, DeviceBackend) \
            else resolve_device(device)
        self.on_corpus = on_corpus
        self.compactor = compactor

        self._lock = threading.Lock()
        self._corpus = corpus
        base_frontier = float(corpus.attr[-1]) if corpus.n_docs else 0.0
        self._start = float(start) if start is not None \
            else math.ceil(base_frontier / self.slice_width) \
            * self.slice_width
        if self._start < base_frontier:
            raise ValueError(
                f"start={self._start} lies inside the base corpus "
                f"(frontier {base_frontier}); slice models would overlap "
                f"existing capital")
        self._frontier = self._start
        self._next_slice = 0             # first un-closed slice index
        self._closed = False

        self._batches = self._docs = self._tokens = 0
        self._built = self._empty = self._errors = 0
        self._lags: List[float] = []
        self._compactions = self._evictions = 0

        self._gen = torch.Generator().manual_seed(seed)
        # (lo, hi, closed_at, corpus snapshot) per closed slice
        self._queue: "queue.Queue[Optional[Tuple]]" = queue.Queue()
        self._builder = threading.Thread(
            target=self._build_loop, name="mlego-ingest-builder",
            daemon=True)
        self._builder.start()

    # ------------------------------------------------------------------
    # producer side
    # ------------------------------------------------------------------
    def _slice_bounds(self, i: int) -> Tuple[float, float]:
        return (self._start + i * self.slice_width,
                self._start + (i + 1) * self.slice_width)

    @property
    def frontier(self) -> float:
        return self._frontier

    @property
    def corpus(self) -> Corpus:
        """The current grown snapshot."""
        return self._corpus

    def append(self, batch: Corpus) -> None:
        """Ingest one document batch (attr-sorted, at/after the
        frontier).  Grows the snapshot, fires ``on_corpus``, and
        enqueues every slice the new frontier closed."""
        if batch.n_docs == 0:
            return
        with self._lock:
            if self._closed:
                raise RuntimeError("ingest pipeline is closed")
            lo = float(batch.attr[0])
            if lo < self._frontier:
                raise ValueError(
                    f"append-only: batch starts at attr {lo}, below the "
                    f"ingest frontier {self._frontier}")
            grown = concat_corpora(self._corpus, batch)
            self._corpus = grown
            self._frontier = float(batch.attr[-1])
            self._batches += 1
            self._docs += batch.n_docs
            self._tokens += batch.n_tokens
            closed = self._drain_closed_slices()
        # callbacks fire outside the lock, corpus first (see the module
        # ordering invariant), then the builder gets the closed slices
        if self.on_corpus is not None:
            self.on_corpus(grown)
        now = time.perf_counter()
        for s_lo, s_hi in closed:
            self._queue.put((s_lo, s_hi, now, grown))

    def _drain_closed_slices(self) -> List[Tuple[float, float]]:
        """Slices whose upper bound the frontier passed (lock held)."""
        out = []
        while True:
            s_lo, s_hi = self._slice_bounds(self._next_slice)
            if s_hi > self._frontier:
                return out
            out.append((s_lo, s_hi))
            self._next_slice += 1

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every enqueued slice is built (True) or the
        timeout expires (False)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._queue.unfinished_tasks == 0:
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            time.sleep(0.005)

    def close(self, build_partial: bool = True) -> None:
        """Stop accepting batches, optionally build the open partial
        slice (append-only means it can never grow again), drain the
        builder, and join it."""
        with self._lock:
            if self._closed:
                if self._builder.is_alive():
                    self._builder.join()
                return
            self._closed = True
            partial = None
            if build_partial:
                s_lo, s_hi = self._slice_bounds(self._next_slice)
                if self._frontier > s_lo:
                    partial = (s_lo, s_hi, time.perf_counter(),
                               self._corpus)
                    self._next_slice += 1
            snapshot = self._corpus
        if partial is not None:
            self._queue.put(partial)
        del snapshot
        self._queue.put(None)            # builder shutdown sentinel
        self._builder.join()

    # ------------------------------------------------------------------
    # builder side
    # ------------------------------------------------------------------
    def _next_gen(self) -> torch.Generator:
        """A child generator on the pipeline's device (the trainer runs
        on ``gen.device``), seeded from the next draw of the stream."""
        with self._lock:
            seed = int(torch.randint(0, 2 ** 62, (), generator=self._gen))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _build_loop(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                self._build_slice(*item)
            except Exception:
                with self._lock:
                    self._errors += 1
            finally:
                self._queue.task_done()

    def _build_slice(self, lo: float, hi: float, closed_at: float,
                     snapshot: Corpus) -> None:
        sub = snapshot.subset(lo, hi)
        if sub.n_docs == 0:
            with self._lock:
                self._empty += 1
            return
        trainer = self.backend.trainer(self.kind) \
            if self.backend is not None else get_trainer(self.kind)
        theta = trainer(sub, self.cfg, self._next_gen())
        m = self.store.add(Interval(lo, hi), sub.n_docs, sub.n_tokens,
                           self.kind, theta)
        if self.backend is not None:
            self.backend.note_trained(m)
        lag = time.perf_counter() - closed_at
        with self._lock:
            self._built += 1
            self._lags.append(lag)
        if self.compactor is not None:
            rep = self.compactor.run()
            with self._lock:
                self._compactions += len(rep.compacted)
                self._evictions += len(rep.evicted)

    # ------------------------------------------------------------------
    def report(self) -> IngestReport:
        with self._lock:
            lags = list(self._lags)
            return IngestReport(
                batches=self._batches, docs=self._docs,
                tokens=self._tokens,
                slices_built=self._built,
                slices_pending=self._queue.unfinished_tasks,
                slices_empty=self._empty,
                build_errors=self._errors,
                frontier=self._frontier,
                freshness_lag_s_last=lags[-1] if lags else 0.0,
                freshness_lag_s_mean=sum(lags) / len(lags)
                if lags else 0.0,
                freshness_lag_s_max=max(lags) if lags else 0.0,
                compactions=self._compactions,
                evictions=self._evictions,
                store_bytes=self.store.nbytes())


__all__ = ["IngestPipeline", "IngestReport"]
