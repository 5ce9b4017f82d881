"""Elastic scaling & failure recovery for the MLego workload.

The materialized-model store makes elasticity *local*: when the worker
count changes (scale-up, scale-down, or a node failure), the covered
attribute space does not need retraining — ranges are re-partitioned to
the new worker count and each worker's model is re-derived by *merging*
the materialized range models that fall inside its new partition
(Alg. 1/2 are associative, so re-binning statistics is exact).  Only
ranges whose models were lost (failed node before materialization) are
retrained, and only those.

This module is host-side control logic; the heavy ops (merge) run
through core/merge.py (or the collective form on device).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.lda_default import LDAConfig
from repro_torch.core.lda import MaterializedModel
from repro_torch.core.merge import merged_theta
from repro_torch.core.plans import Interval, subtract
from repro_torch.core.store import ModelStore


@dataclasses.dataclass
class Partition:
    worker: int
    span: Interval
    model_ids: List[int]           # store models merged into this worker
    missing: List[Interval]        # ranges that must be (re)trained


def partition_ranges(universe: Interval, n_workers: int) -> List[Interval]:
    edges = np.linspace(universe.lo, universe.hi, n_workers + 1)
    return [Interval(float(a), float(b)) for a, b in zip(edges, edges[1:])]


def plan_repartition(store: ModelStore, universe: Interval, n_workers: int,
                     kind: str = "vb") -> List[Partition]:
    """Assign store models to the new worker partitions.

    A model is assigned to the worker whose span contains it; models
    straddling a boundary are left out (their range joins ``missing`` —
    the retrain set) so every worker's merge stays exact.
    """
    spans = partition_ranges(universe, n_workers)
    parts: List[Partition] = []
    for w, span in enumerate(spans):
        inside = [m for m in store.models(kind) if span.contains(m.o)]
        # greedy non-overlapping cover, largest models first
        inside.sort(key=lambda m: -(m.o.hi - m.o.lo))
        chosen: List[MaterializedModel] = []
        for m in inside:
            if all(not m.o.overlaps(c.o) for c in chosen):
                chosen.append(m)
        missing = subtract(span, [m.o for m in chosen])
        parts.append(Partition(w, span, [m.model_id for m in chosen],
                               missing))
    return parts


def apply_repartition(parts: Sequence[Partition], store: ModelStore,
                      cfg: LDAConfig, train_fn) -> Dict[int, MaterializedModel]:
    """Build each worker's model: retrain missing ranges, then merge.

    ``train_fn(lo, hi)`` trains + materializes one range (the
    MLegoSession.train_range signature).  Returns worker -> merged model.
    """
    out: Dict[int, MaterializedModel] = {}
    for part in parts:
        models = [store.get(mid) for mid in part.model_ids]
        for gap in part.missing:
            m = train_fn(gap.lo, gap.hi)
            if m is not None:
                models.append(m)
        if not models:
            continue
        theta, kind = merged_theta(models, cfg)
        n_docs = sum(m.n_docs for m in models)
        n_tokens = sum(m.n_tokens for m in models)
        out[part.worker] = MaterializedModel(
            -(part.worker + 1), part.span, n_docs, n_tokens, kind, theta)
    return out


def recover_failed(store: ModelStore, failed_ranges: Sequence[Interval],
                   train_fn) -> List[MaterializedModel]:
    """Node-failure recovery: retrain exactly the lost ranges.

    Because Alg. 1/2 merges are order-independent reductions, a lost
    partition's delta is simply absent — recovery is local retraining
    of the lost ranges, then normal merging; nothing global restarts.
    """
    fresh = []
    for r in failed_ranges:
        covered = [m.o for m in store.models() if r.contains(m.o)]
        for gap in subtract(r, covered):
            m = train_fn(gap.lo, gap.hi)
            if m is not None:
                fresh.append(m)
    return fresh


def recover_quarantined(store: ModelStore, train_fn, *,
                        clear: bool = True) -> List[MaterializedModel]:
    """Retrain the ranges of the store's quarantined blobs.

    ``ModelStore.load(on_corrupt="quarantine")`` and runtime
    ``store.quarantine`` leave a ledger of blobs the store dropped
    (checksum mismatch, truncation, device loss mid-write); each entry
    carries the original range ``o``.  This is the same local-recovery
    argument as ``recover_failed``: a dropped blob is just a missing
    range, so recovery is retraining exactly those ranges — restricted
    to the parts not already covered by healthy capital (a re-ingested
    or compacted replacement makes retraining moot).  ``train_fn``
    persists through the normal path (``MLegoSession.train_range``),
    so the replacement blobs are checksummed and crash-safe.  With
    ``clear=True`` the ledger is drained afterwards — the quarantine
    has been acted on.
    """
    lost = [q.o for q in store.quarantined]
    fresh = recover_failed(store, lost, train_fn)
    if clear:
        store.clear_quarantined()
    return fresh
