"""Batch query optimization (paper §V.C, Alg. 4).

Execution model (the paper's Fig. 5 semantics, made precise):

  A batch Q = {q_1..q_b} chooses one plan per query.  The *uncovered*
  gap ranges of all chosen plans are split into atomic segments at every
  gap endpoint; each atomic segment is trained ONCE and the fresh
  segment model is reused by every query whose gaps contain it.  So

    T(P)      = sum_s c_train(s) over distinct segments + merge costs,
    Benefit   B(P) = sum_s (|s| - 1) * c_train(s)            (Def. 3)

  where |s| is the number of plans whose gaps contain segment s — the
  training time saved versus executing every query alone.

Alg. 4 (heuristic): start from each query's top-1 (alpha = 0) plan; for
each query, take its L_1 (RL) plans, drop every model m whose pseudo-
combination benefit exceeds its training cost
(B({m, P^{-q}}) - c_t(m) > 0 — the paper's line 9 criterion: if m's
range is largely trained by the other queries anyway, training it
shared is cheaper than merging the materialized model), then rank the
pruned plans by B - dt (Thm. 6 scoring) and keep the best.  Queries are
processed in order, updating P in place.

``batch_oracle`` exhaustively scores every plan combination (NP-hard in
general — Thm. 5) for small instances; the property tests assert the
heuristic is never worse than the no-sharing default and never better
than the oracle.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost import CostProvider, plan_stats
from repro_torch.core.plan_ir import Plan
from repro_torch.core.plans import Interval, plan_key, rl_plans, subtract, usable
from repro_torch.core.search import lower, psoa_search


@dataclass
class BatchResult:
    plans: List[Tuple]           # chosen plan per query (parallel to queries)
    total_time: float            # T(P): shared training + merges
    naive_time: float            # sum of per-query times, no sharing
    benefit: float               # B(P)  (Def. 3)
    n_scored: int = 0
    elapsed_s: float = 0.0
    method: str = ""
    irs: List[Plan] = field(default_factory=list)   # lowered Plan IR per query
    alpha: float = 0.0           # weight used for the initial per-query plans


# ---------------------------------------------------------------------------
# segment algebra
# ---------------------------------------------------------------------------

def _gaps(plan: Tuple, query: Interval) -> List[Interval]:
    return subtract(query, [m.o for m in plan])


def _segments(gap_lists: Sequence[List[Interval]]) -> List[Tuple[float, float, int]]:
    """Atomic segments of the union of all gap lists -> (lo, hi, count)."""
    points = sorted({e for gaps in gap_lists for g in gaps for e in (g.lo, g.hi)})
    out = []
    for lo, hi in zip(points, points[1:]):
        mid = 0.5 * (lo + hi)
        cnt = sum(1 for gaps in gap_lists
                  if any(g.lo <= mid < g.hi for g in gaps))
        if cnt > 0:
            out.append((lo, hi, cnt))
    return out


def shared_time_and_benefit(plans: Sequence[Tuple], queries: Sequence[Interval],
                            index, cost: CostProvider
                            ) -> Tuple[float, float, float]:
    """(T, naive_T, B) for a plan combination (Def. 3 accounting).

    Merge launches are priced pad-free: the ragged segmented kernel
    packs every plan's parts into one launch with zero pad rows, so the
    size-bucketed pad term that used to ride on batched device merges
    no longer appears in T(P).  (``cost.padding_cost`` still prices
    explicit pad rows for callers that bucket — see the benchmarks.)
    """
    gap_lists = [_gaps(p, q) for p, q in zip(plans, queries)]
    segs = _segments(gap_lists)
    t_train = sum(cost.c_train(index.tokens_in(lo, hi)) for lo, hi, _ in segs)
    saved = sum((cnt - 1) * cost.c_train(index.tokens_in(lo, hi))
                for lo, hi, cnt in segs)
    t_merge = 0.0
    for p, gaps in zip(plans, gap_lists):
        comps = len(p) + sum(1 for g in gaps if index.tokens_in(g.lo, g.hi) > 0)
        t_merge += cost.c_merge(max(comps - 1, 0))
    total = t_train + t_merge
    return total, total + saved, saved


# ---------------------------------------------------------------------------
# Alg. 4 heuristic
# ---------------------------------------------------------------------------

def processing_order(queries: Sequence[Interval], index) -> List[int]:
    """§V.C batch reorder: process wide queries first.

    Alg. 4 updates plans in processing order, so earlier queries anchor
    the shared-segment structure later ones prune against.  Visiting
    queries by descending selected-token volume lets the widest ranges
    lay down the shared gaps before narrow queries decide what to drop.
    Ties (and the common all-equal case) preserve submission order.
    """
    toks = [float(index.tokens_in(q.lo, q.hi)) for q in queries]
    return sorted(range(len(queries)), key=lambda i: (-toks[i], i))


def batch_optimize(models: Sequence, queries: Sequence[Interval], index,
                   cost: CostProvider, *, alpha: float = 0.0,
                   max_rl_plans: int = 64,
                   order: Optional[Sequence[int]] = None) -> BatchResult:
    t0 = time.perf_counter()
    b = len(queries)
    # line 2-3: initial P = top-1 plan per query (alpha threaded from the
    # specs; 0.0 keeps the paper's pure time-cost regime)
    plans: List[Tuple] = []
    n_scored = 0
    for q in queries:
        r = psoa_search(models, q, index, cost, alpha)
        plans.append(r.plan)
        n_scored += r.n_scored

    for i in (range(b) if order is None else order):
        q = queries[i]
        others = [plans[j] for j in range(b) if j != i]
        other_qs = [queries[j] for j in range(b) if j != i]
        other_gaps = [_gaps(p, oq) for p, oq in zip(others, other_qs)]
        # loop-invariant: the no-m benefit baseline over the other
        # queries' gaps does not depend on the candidate model
        base = sum((cnt - 1) * cost.c_train(index.tokens_in(lo, hi))
                   for lo, hi, cnt in _segments(other_gaps))

        cand_models = [m for m in usable(models, q)
                       if index.tokens_in(m.o.lo, m.o.hi) > 0]
        roots = rl_plans(cand_models, q)[:max_rl_plans]

        # line 5: pseudo-combination benefit of each model
        drop: Dict[int, bool] = {}
        for m in cand_models:
            pseudo = other_gaps + [[m.o]]
            segs = _segments(pseudo)
            bene = sum((cnt - 1) * cost.c_train(index.tokens_in(lo, hi))
                       for lo, hi, cnt in segs)
            c_m = cost.c_train(index.tokens_in(m.o.lo, m.o.hi))
            drop[m.model_id] = (bene - base) - c_m > 0.0
            n_scored += 1

        # lines 7-13: prune each L_1 plan, rank by T(P) with qi swapped in
        best_plan, best_t = plans[i], None
        seen = set()
        for p in roots + [plans[i]]:
            p_star = tuple(m for m in p if not drop.get(m.model_id, False))
            k = plan_key(p_star)
            if k in seen:
                continue
            seen.add(k)
            trial = [(p_star if j == i else plans[j]) for j in range(b)]
            t_tot, _, _ = shared_time_and_benefit(trial, queries, index, cost)
            n_scored += 1
            if best_t is None or t_tot < best_t:
                best_plan, best_t = p_star, t_tot
        plans[i] = best_plan

    total, naive, bene = shared_time_and_benefit(plans, queries, index, cost)
    return BatchResult(plans, total, naive, bene, n_scored=n_scored,
                       elapsed_s=time.perf_counter() - t0, method="ALG4",
                       irs=[lower(p, q, index)
                            for p, q in zip(plans, queries)],
                       alpha=alpha)


# ---------------------------------------------------------------------------
# exhaustive oracle (Thm. 5 problem, small instances only)
# ---------------------------------------------------------------------------

def batch_oracle(models: Sequence, queries: Sequence[Interval], index,
                 cost: CostProvider, *, max_combos: int = 200_000
                 ) -> BatchResult:
    t0 = time.perf_counter()
    per_query: List[List[Tuple]] = []
    for q in queries:
        cand = [m for m in usable(models, q)
                if index.tokens_in(m.o.lo, m.o.hi) > 0]
        roots = rl_plans(cand, q)
        # all sub-plans of all roots (deduped) — the full plan space
        space: Dict[Tuple, Tuple] = {(): ()}
        stack = list(roots)
        while stack:
            p = stack.pop()
            k = plan_key(p)
            if k in space:
                continue
            space[k] = p
            for j in range(len(p)):
                stack.append(p[:j] + p[j + 1:])
        per_query.append(list(space.values()))

    n_combo = 1
    for s in per_query:
        n_combo *= len(s)
    if n_combo > max_combos:
        raise ValueError(f"{n_combo} combinations exceed the oracle budget")

    best, best_t = None, float("inf")
    n_scored = 0
    for combo in itertools.product(*per_query):
        t_tot, _, _ = shared_time_and_benefit(list(combo), queries, index, cost)
        n_scored += 1
        if t_tot < best_t:
            best, best_t = list(combo), t_tot
    total, naive, bene = shared_time_and_benefit(best, queries, index, cost)
    return BatchResult(best, total, naive, bene, n_scored=n_scored,
                       elapsed_s=time.perf_counter() - t0, method="ORACLE",
                       irs=[lower(p, q, index)
                            for p, q in zip(best, queries)])
