"""Planner internals — the Fig. 2 "plan search" stage behind the session.

Thin, stateful-only-in-inputs wrapper over the §V.B searchers and the
§V.C Alg. 4 batch optimizer, so the session (and any future scheduler)
talks to one object instead of reaching into ``repro_torch.core.search`` /
``repro_torch.core.batch_opt`` directly.  Both paths return results carrying
the lowered **Plan IR** the executor consumes.

``PlanCache`` is the session-level memo over ``Planner.plan``:
interactive exploration replays near-identical queries (pan/zoom over
σ, re-render after a UI tweak), and for those the search is pure —
same predicate, same model set, same α, same prices ⇒ same plan.
Entries are keyed by (normalized σ, model-set fingerprint, α, trainer
kind, search method, backend, cost provider + version) and the whole
cache drops on any ``ModelStore`` mutation through the store's
``subscribe`` channel — the same transport the device backend's model
cache invalidates over.

One ``PlanCache`` may be **shared by many sessions over the same
store** (``MLegoSession(plan_cache=...)``, the serving layer's
default): every key carries the model-set fingerprint *and* the cost
provider identity + version, so entries are value-addressed — a hit in
session B for a plan session A searched is correct by construction,
and sessions pricing through different providers can never serve each
other's plans.  Lookup/insert are lock-serialized.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.batch_opt import BatchResult, batch_optimize, processing_order
from repro_torch.core.cost import CostProvider
from repro_torch.core.plans import Interval, subtract
from repro_torch.core.search import SEARCHERS, SearchResult


class PlanCache:
    """Store-subscribed memo of ``SearchResult``s, LRU-bounded.

    A fingerprint of the usable model set rides in every key, so even
    a stale entry could never be served for a mutated store; clearing
    on the subscribe channel additionally keeps the cache from filling
    with unreachable generations.
    """

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._entries: "OrderedDict[Tuple, SearchResult]" = OrderedDict()
        self._lock = threading.RLock()
        self._store = None
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def store(self):
        """The store this cache invalidates over (None if unbound)."""
        return self._store

    # --- store subscription -------------------------------------------------
    def bind_store(self, store) -> None:
        """Subscribe to ``store``'s mutations.  Binding the already-
        bound store is a no-op, which is what lets many sessions over
        one shared store adopt one shared cache; binding a *different*
        store clears the cache and re-homes the subscription (the
        legacy store-swap path — every sharing session sees the
        clear)."""
        with self._lock:
            if store is self._store:
                return
            if self._store is not None:
                self._store.unsubscribe(self._on_store_event)
            self._store = store
            self.clear()
            if store is not None:
                store.subscribe(self._on_store_event)

    def _on_store_event(self, event: str, model_id: int) -> None:
        with self._lock:
            if self._entries:
                self.invalidations += 1
            self.clear()

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    # --- lookup ---------------------------------------------------------------
    @staticmethod
    def fingerprint(models: Sequence) -> int:
        """Value identity of a model set (ids + ranges)."""
        return hash(tuple(sorted(
            (m.model_id, m.o.lo, m.o.hi) for m in models)))

    def peek(self, key: Tuple) -> Optional[SearchResult]:
        """Non-counting, non-promoting lookup — the serving layer's
        SLO loop probes "is this plan already paid for?" without
        polluting the hit/miss telemetry or the LRU order."""
        with self._lock:
            return self._entries.get(key)

    def get(self, key: Tuple) -> Optional[SearchResult]:
        with self._lock:
            res = self._entries.get(key)
            if res is None:
                self.misses += 1
                return None
            self.hits += 1
            self._entries.move_to_end(key)
            return res

    def put(self, key: Tuple, res: SearchResult) -> None:
        with self._lock:
            self._entries[key] = res
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)


class Planner:
    def __init__(self, index, cost: CostProvider):
        self.index = index
        self.cost = cost

    def plan(self, models: Sequence, sigma: Interval, alpha: float,
             method: str = "psoa++") -> SearchResult:
        """Best plan for one interval (Def. 2 score-based search)."""
        try:
            searcher = SEARCHERS[method]
        except KeyError:
            raise ValueError(f"unknown plan-search method {method!r}; "
                             f"one of {sorted(SEARCHERS)}") from None
        return searcher(models, sigma, self.index, self.cost, alpha)

    def plan_batch(self, models: Sequence, sigmas: Sequence[Interval],
                   alpha: float = 0.0, *, reorder: bool = True
                   ) -> BatchResult:
        """Alg. 4 joint plan combination for a batch of intervals.

        ``alpha`` seeds the initial per-query plans (threaded from the
        specs; Alg. 4's joint pruning itself stays time-cost based).
        ``reorder`` applies the §V.C processing order (widest query
        first); False preserves submission order.
        """
        sigmas = list(sigmas)
        order = processing_order(sigmas, self.index) if reorder else None
        return batch_optimize(models, sigmas, self.index, self.cost,
                              alpha=alpha, order=order)

    @staticmethod
    def gaps(sigma: Interval, plan: Sequence) -> List[Interval]:
        """Uncovered ranges of ``sigma`` under ``plan`` (to be trained)."""
        return subtract(sigma, [m.o for m in plan])
