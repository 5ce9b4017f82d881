"""Capital compaction & eviction — keeping streaming capital bounded.

Streaming ingestion (``repro_torch.ingest.pipeline``) appends one base model
per time slice forever; left alone the store grows without bound and
every wide query pays a merge part per fine slice.  The compactor
enforces a byte budget over the managed kind's capital in two moves:

  **compact**  merge a contiguous run of the *oldest* slices into one
               coarse segment via the kind's merge family (Alg. 1 for
               the vb family, Alg. 2 for gs).  Both merges are exact
               natural-parameter additions, so a query that later
               merges the coarse segment with its neighbors computes
               the *same* β it would have from the fine slices — the
               only cost of compaction is range resolution (a query
               can no longer align to a boundary inside the segment).
               The swap goes through ``ModelStore.replace`` (atomic;
               "add" before "remove"s on the subscribe channel).

  **evict**    when compaction alone cannot reach the budget, drop the
               coldest managed models (least-recently fetched per the
               store's access clock, ties broken oldest-range /
               lowest-id first — fully deterministic for a fixed slice
               set and access history).

Only kinds with a built-in merge family compact (custom merge
callables have no materializable merged Θ); eviction applies to any
managed model.  The newest ``min_retained`` slices are exempt from
both moves — they are the hot frontier queries align to.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.api.trainers import merge_family_name, resolve_kind
from repro_torch.configs.lda_default import LDAConfig
from repro_torch.core.lda import MaterializedModel
from repro_torch.core.merge import merge_gs, merge_vb
from repro_torch.core.plans import Interval
from repro_torch.core.store import ModelStore

# contiguity tolerance: slice bounds come from one grid expression
# (i * width), so adjacent bounds are bit-identical; the epsilon only
# forgives float noise in hand-built stores
_EPS = 1e-9


@dataclass(frozen=True)
class CompactionPolicy:
    """When and how hard to compact.

    max_bytes    : byte budget over the managed kind's capital
    merge_width  : fine models fused per compaction step
    min_retained : newest models (by range start) never touched
    evict        : allow cold-capital eviction when merging contiguous
                   runs cannot reach the budget alone
    """

    max_bytes: int
    merge_width: int = 4
    min_retained: int = 1
    evict: bool = True

    def __post_init__(self):
        if self.merge_width < 2:
            raise ValueError("merge_width must be >= 2")


@dataclass(frozen=True)
class CompactionReport:
    """One ``Compactor.run``'s ledger."""

    bytes_before: int
    bytes_after: int
    compacted: Tuple[Tuple[int, ...], ...] = ()   # replaced id groups
    compacted_into: Tuple[int, ...] = ()          # one coarse id per group
    evicted: Tuple[int, ...] = ()

    @property
    def changed(self) -> bool:
        return bool(self.compacted or self.evicted)


@dataclass(frozen=True)
class CompactionTotals:
    """Cumulative counters across every ``run`` (for service reports)."""

    runs: int = 0
    compactions: int = 0
    evictions: int = 0
    bytes_reclaimed: int = 0


class Compactor:
    """Budget enforcement over one store's managed kind.

    ``run()`` is idempotent at the fixpoint (under budget, or nothing
    left to move) and safe to call from the ingest builder thread —
    every store mutation it makes flows through the subscribe channel,
    so concurrent sessions' plan caches and device LRUs invalidate as
    for any manual mutation.  Runs are serialized by an internal lock.
    """

    def __init__(self, store: ModelStore, cfg: LDAConfig,
                 policy: CompactionPolicy, kind: str = "vb"):
        self.store = store
        self.cfg = cfg
        self.policy = policy
        self.kind = resolve_kind(kind)
        self.family = merge_family_name(self.kind)
        if self.family is None:
            raise ValueError(
                f"kind {self.kind!r} has a custom merge callable — no "
                f"materializable merged Θ, so it cannot compact (eviction"
                f"-only policies must still name a mergeable kind)")
        self._lock = threading.Lock()
        self._totals = CompactionTotals()

    # ------------------------------------------------------------------
    def managed(self) -> List[MaterializedModel]:
        """The models under budget, oldest range first."""
        out = []
        for m in self.store.models():
            try:
                mk = resolve_kind(m.kind)
            except ValueError:
                continue
            if mk == self.kind:
                out.append(m)
        return sorted(out, key=lambda m: (m.o.lo, m.o.hi, m.model_id))

    def bytes_used(self) -> int:
        return sum(m.nbytes() for m in self.managed())

    @property
    def totals(self) -> CompactionTotals:
        return self._totals

    # ------------------------------------------------------------------
    def _merged_theta(self, group: Sequence[MaterializedModel]) -> dict:
        if self.family == "vb":
            return {"lam": merge_vb(list(group), self.cfg)}
        return {"delta_nkv": merge_gs(list(group), self.cfg)}

    def _oldest_run(self, models: List[MaterializedModel]
                    ) -> Optional[List[MaterializedModel]]:
        """Oldest contiguous run of ``merge_width`` movable models."""
        movable = models[: max(len(models) - self.policy.min_retained, 0)]
        width = self.policy.merge_width
        run: List[MaterializedModel] = []
        for m in movable:
            if run and abs(m.o.lo - run[-1].o.hi) > _EPS * max(
                    1.0, abs(run[-1].o.hi)):
                run = []
            run.append(m)
            if len(run) == width:
                return run
        return None

    def _coldest(self, models: List[MaterializedModel]
                 ) -> Optional[MaterializedModel]:
        movable = models[: max(len(models) - self.policy.min_retained, 0)]
        if not movable:
            return None
        return min(movable, key=lambda m: (self.store.last_access(
            m.model_id), m.o.lo, m.model_id))

    # ------------------------------------------------------------------
    def run(self) -> CompactionReport:
        """Compact/evict until the managed capital fits the budget (or
        nothing movable remains).  Returns this run's ledger."""
        with self._lock:
            bytes_before = self.bytes_used()
            used = bytes_before
            compacted: List[Tuple[int, ...]] = []
            into: List[int] = []
            evicted: List[int] = []
            while used > self.policy.max_bytes:
                models = self.managed()
                group = self._oldest_run(models)
                if group is not None:
                    coarse = self.store.replace(
                        [m.model_id for m in group],
                        Interval(group[0].o.lo, group[-1].o.hi),
                        sum(m.n_docs for m in group),
                        sum(m.n_tokens for m in group),
                        self.kind, self._merged_theta(group))
                    compacted.append(tuple(m.model_id for m in group))
                    into.append(coarse.model_id)
                elif self.policy.evict:
                    cold = self._coldest(models)
                    if cold is None:
                        break
                    self.store.remove(cold.model_id)
                    evicted.append(cold.model_id)
                else:
                    break
                used = self.bytes_used()
            t = self._totals
            self._totals = CompactionTotals(
                runs=t.runs + 1,
                compactions=t.compactions + len(compacted),
                evictions=t.evictions + len(evicted),
                bytes_reclaimed=t.bytes_reclaimed
                + max(bytes_before - used, 0))
            return CompactionReport(
                bytes_before=bytes_before, bytes_after=used,
                compacted=tuple(compacted), compacted_into=tuple(into),
                evicted=tuple(evicted))


__all__ = ["CompactionPolicy", "CompactionReport", "CompactionTotals",
           "Compactor"]
