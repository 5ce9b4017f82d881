"""Plan searching — NAI, GRA, PSOA, PSOA++ (paper §V.B, Alg. 3).

All four searchers solve Definition 2 (score-based plan searching):

    p* = argmin_{p in P} sc(p)   s.t. sc(p) > 0 or p reuses models,
    sc  = alpha * l_p + (1 - alpha) * c_t                       (Eq. 2)

(Def. 2's sc > 0 constraint exists to bar the *empty* plan — scratch
training has perfect quality, so it scores 0 whenever alpha = 1 and
would trivially win.  A nonempty zero-score plan is the opposite
extreme and genuinely optimal: a single stored model exactly covering
sigma has no merges, no training, and no fetch cost — the direct-hit
plan every alpha must prefer over retraining.)

  * ``nai_search``   — generate-and-rank: enumerate every candidate plan
    (all antichains of usable models — exponential), score all, rank.
  * ``gra_search``   — the [20] baseline: DAG over range endpoints,
    shortest path = max-coverage plan.  Only valid when the score
    reduces to training cost (alpha = 0, merge cost negligible).
  * ``psoa_search``  — hierarchical threshold (top-k) search over three
    ordered lists (l_p, c_t(merge), c_t(train)) seeded by RL plans,
    kept sorted with the Thm. 2 "push down" rule.
  * PSOA++           — the §V.B.5 improvement: when alpha = 0 the l_p
    list is dropped, and when the plan width is under the Thm. 3/4
    critical point x* the merge list is dropped too; the problem
    degenerates to maximize-coverage and is answered from the first
    c_t(train) layer directly (this is exactly where GRA applies).

Every searcher returns a ``SearchResult`` carrying the chosen plan —
both the legacy model tuple and its lowered Plan IR (``ir``) — its
exact score and work counters (#plans scored, #layers generated) so the
Fig. 10–12 benchmarks can report search effort as well as wall time.

Candidate scoring goes through the pluggable ``CostProvider``
(``cost.score_models``): the analytic ``CostModel`` reproduces the
paper's Eq. 2 exactly, while a ``CalibratedCostModel`` additionally
prices device-cache hits and host→device transfers per model, so the
same searchers become backend-aware without changing their control
flow.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost import CostProvider, plan_stats
from repro_torch.core.plan_ir import Plan
from repro_torch.core.plans import Interval, all_plans, children, plan_key, rl_plans, subtract, usable


@dataclass
class SearchResult:
    plan: Tuple                  # legacy model-tuple view of the plan
    score: float
    alpha: float
    n_scored: int = 0            # exact score evaluations
    n_generated: int = 0         # candidate plans materialized
    n_layers: int = 0            # layers expanded (PSOA)
    elapsed_s: float = 0.0
    method: str = ""
    ir: Optional[Plan] = None    # lowered Plan IR (what executors consume)

    @property
    def model_ids(self) -> Tuple[int, ...]:
        return tuple(sorted(m.model_id for m in self.plan))


def lower(plan: Tuple, query: Interval, index) -> Plan:
    """Model tuple -> Plan IR (searchers lower their chosen plan once)."""
    return Plan.from_models(plan, query, index)


def _scratch_tokens(query: Interval, index) -> float:
    return float(index.tokens_in(query.lo, query.hi))


def _exact_score(plan, query, index, cost: CostProvider, alpha: float,
                 scratch: float) -> float:
    return cost.score_models(plan, query, index, alpha, scratch)


# ---------------------------------------------------------------------------
# NAI — generate-and-rank (paper §V.B.1)
# ---------------------------------------------------------------------------

def nai_search(models: Sequence, query: Interval, index,
               cost: CostProvider, alpha: float) -> SearchResult:
    t0 = time.perf_counter()
    scratch = _scratch_tokens(query, index)
    plans = all_plans(models, query)
    best, best_sc = (), float("inf")
    n_scored = 0
    for p in plans:
        sc = _exact_score(p, query, index, cost, alpha, scratch)
        n_scored += 1
        if (sc > 0.0 or p) and sc < best_sc:
            best, best_sc = p, sc
    return SearchResult(best, best_sc, alpha, n_scored=n_scored,
                        n_generated=len(plans),
                        elapsed_s=time.perf_counter() - t0, method="NAI",
                        ir=lower(best, query, index))


# ---------------------------------------------------------------------------
# GRA — DAG shortest path (the [20] baseline; max-coverage regime only)
# ---------------------------------------------------------------------------

def gra_search(models: Sequence, query: Interval, index,
               cost: CostProvider) -> SearchResult:
    """Left-to-right DP over range endpoints minimizing trained tokens.

    Node set: query endpoints + usable-model endpoints, sorted.  Edges:
      gap   (node_i -> node_{i+1})  weight c_train(tokens between)
      model (m.lo  -> m.hi)         weight t_m (one merge)
    The shortest path is the coverage-maximal plan; valid when the
    score is pure time cost (alpha = 0 regime of Fig. 10).
    """
    t0 = time.perf_counter()
    cand = usable(models, query)
    nodes = sorted({query.lo, query.hi}
                   | {m.o.lo for m in cand} | {m.o.hi for m in cand})
    pos = {x: i for i, x in enumerate(nodes)}
    n = len(nodes)
    dist = [float("inf")] * n
    back: List[Optional[Tuple[int, Optional[object]]]] = [None] * n
    dist[0] = 0.0
    by_lo: Dict[int, List] = {}
    for m in cand:
        by_lo.setdefault(pos[m.o.lo], []).append(m)
    n_scored = 0
    for i in range(n):
        if dist[i] == float("inf"):
            continue
        if i + 1 < n:
            w = cost.c_train(index.tokens_in(nodes[i], nodes[i + 1]))
            n_scored += 1
            if dist[i] + w < dist[i + 1]:
                dist[i + 1] = dist[i] + w
                back[i + 1] = (i, None)
        for m in by_lo.get(i, ()):
            j = pos[m.o.hi]
            w = cost.t_merge
            if dist[i] + w < dist[j]:
                dist[j] = dist[i] + w
                back[j] = (i, m)
    plan: List = []
    i = n - 1
    while i != 0:
        prev, m = back[i]
        if m is not None:
            plan.append(m)
        i = prev
    plan_t = tuple(reversed(plan))
    scratch = _scratch_tokens(query, index)
    sc = _exact_score(plan_t, query, index, cost, 0.0, scratch)
    return SearchResult(plan_t, sc, 0.0, n_scored=n_scored,
                        n_generated=len(cand) + n,
                        elapsed_s=time.perf_counter() - t0, method="GRA",
                        ir=lower(plan_t, query, index))


# ---------------------------------------------------------------------------
# PSOA — hierarchical threshold search (Alg. 3)
# ---------------------------------------------------------------------------

class _BfsLayers:
    """Layered plan generation for the l_p / c_t(merge) lists.

    L_i = all antichains with i models.  Each antichain is produced
    exactly once by extending its sorted prefix at the right end.
    """

    def __init__(self, cand: Sequence):
        self.cand = sorted(cand, key=lambda m: (m.o.lo, m.o.hi))
        self.layer: List[Tuple] = [(m,) for m in self.cand]
        self.i = 0
        self.n_generated = len(self.layer)

    def next_layer(self) -> List[Tuple]:
        if self.i == 0:
            self.i = 1
            return self.layer
        new: List[Tuple] = []
        for p in self.layer:
            end = p[-1].o.hi
            for m in self.cand:
                if m.o.lo >= end:
                    new.append(p + (m,))
        self.layer = new
        self.i += 1
        self.n_generated += len(new)
        return new


class _TrainLayers:
    """Layered c_t(train) list: RL plans first, children next, with the
    Thm. 2 push-down keeping cross-layer train-cost order."""

    def __init__(self, roots: Sequence[Tuple], query: Interval, index):
        self.query = query
        self.index = index
        self.layer: List[Tuple] = list(roots)
        self.emitted: set = set()
        self.n_generated = len(roots)

    def _covered(self, p: Tuple) -> float:
        return float(sum(self.index.tokens_in(m.o.lo, m.o.hi) for m in p))

    def _min_model(self, p: Tuple) -> float:
        return min(float(self.index.tokens_in(m.o.lo, m.o.hi)) for m in p)

    def next_layer(self) -> List[Tuple]:
        if not self.layer:
            return []
        cov = {plan_key(p): self._covered(p) for p in self.layer}
        # Thm. 2: best achievable child coverage this layer
        parents = [p for p in self.layer if len(p) > 0]
        best_child = max((cov[plan_key(p)] - self._min_model(p)
                          for p in parents), default=float("-inf"))
        stay = [p for p in self.layer if cov[plan_key(p)] > best_child]
        pushed = [p for p in self.layer if cov[plan_key(p)] <= best_child]
        if not stay:   # strict progress: keep the max-coverage plan
            top = max(self.layer, key=lambda p: cov[plan_key(p)])
            stay = [top]
            pushed = [p for p in self.layer if p is not top]
        out: List[Tuple] = []
        for p in stay:
            k = plan_key(p)
            if k not in self.emitted:
                self.emitted.add(k)
                out.append(p)
        nxt: Dict[Tuple, Tuple] = {}
        for p in stay:
            for c in children(p):
                k = plan_key(c)
                if k not in self.emitted:
                    nxt[k] = c
        for p in pushed:
            nxt.setdefault(plan_key(p), p)
        self.layer = list(nxt.values())
        self.n_generated += len(self.layer)
        return out


def psoa_search(models: Sequence, query: Interval, index,
                cost: CostProvider, alpha: float, *, use_plus: bool = True,
                max_layers: int = 10_000) -> SearchResult:
    """Alg. 3 — hierarchical plan search with the threshold algorithm.

    ``use_plus`` enables the §V.B.5 list-merging improvement (PSOA++):
    with alpha = 0 the l_p list is dropped, and below the Thm. 3/4
    critical point the merge list collapses into the train list.
    """
    t0 = time.perf_counter()
    cand = [m for m in usable(models, query)
            if index.tokens_in(m.o.lo, m.o.hi) > 0]
    scratch = _scratch_tokens(query, index)
    roots = rl_plans(cand, query)
    n_layers = 0

    # ---- alpha = 1 (Alg. 3 line 5): maximal reuse among RL plans -------
    if alpha >= 1.0:
        best = max(roots, key=len) if roots else ()
        sc = _exact_score(best, query, index, cost, alpha, scratch)
        return SearchResult(best, sc, alpha, n_scored=len(roots),
                            n_generated=len(roots),
                            elapsed_s=time.perf_counter() - t0,
                            method="PSOA", ir=lower(best, query, index))

    # ---- PSOA++: alpha = 0 below the critical point x* ------------------
    if use_plus and alpha == 0.0 and cand:
        width = max((len(p) for p in roots), default=0)
        min_tok = min(float(index.tokens_in(m.o.lo, m.o.hi)) for m in cand)
        if width <= cost.critical_x(min_tok):
            # merge cost negligible -> maximize coverage (GRA regime):
            # answer directly from the first c_t(train) layer.
            def unc(p):
                return plan_stats(p, query, index)[1]
            best = min(roots, key=unc) if roots else ()
            sc = _exact_score(best, query, index, cost, alpha, scratch)
            return SearchResult(best, sc, alpha, n_scored=len(roots),
                                n_generated=len(roots), n_layers=1,
                                elapsed_s=time.perf_counter() - t0,
                                method="PSOA++",
                                ir=lower(best, query, index))

    # ---- general threshold search over the three lists ------------------
    bfs = _BfsLayers(cand)          # drives l_p and c_t(merge) bounds
    tl = _TrainLayers(roots, query, index)
    denom = max(cost.c_train(scratch), 1e-30)

    scored: Dict[Tuple, float] = {}
    best_plan: Tuple = ()
    best_sc = float("inf")
    # the empty plan (train everything) is always a candidate — unless
    # it scores 0 (the alpha = 1 degeneracy Def. 2's constraint bars)
    sc0 = _exact_score((), query, index, cost, alpha, scratch)
    if sc0 > 0.0:
        best_plan, best_sc = (), sc0
    scored[()] = sc0

    def see(p: Tuple):
        nonlocal best_plan, best_sc
        k = plan_key(p)
        if k in scored:
            return
        sc = _exact_score(p, query, index, cost, alpha, scratch)
        scored[k] = sc
        if (sc > 0.0 or p) and sc < best_sc:
            best_plan, best_sc = p, sc

    bfs_done = train_done = False
    r = 0
    while r < max_layers and not (bfs_done and train_done):
        r += 1
        n_layers += 1
        # advance the joint l_p / merge list (layer r = r-model plans)
        if not bfs_done:
            layer_a = bfs.next_layer()
            if not layer_a:
                bfs_done = True
            for p in layer_a:
                see(p)
        # advance the train list
        if not train_done:
            layer_c = tl.next_layer()
            if not layer_c and not tl.layer:
                train_done = True
            for p in layer_c:
                see(p)
        # ---- threshold (lower bound over every unseen plan) ------------
        # unseen plans have >= r+1 models (list A exhausted layer r)
        if bfs_done:
            lp_lb = float("inf")
            merge_lb = float("inf")
        else:
            lp_lb = cost.ploss.loss(r)           # >= r+1 models -> >= r merges
            merge_lb = cost.c_merge(r) / denom
        if train_done:
            train_lb = float("inf")
        elif tl.layer:
            train_lb = min(cost.c_train(plan_stats(p, query, index)[1])
                           for p in tl.layer) / denom
        else:
            train_lb = float("inf")
        # (guard 0 * inf)
        th = 0.0
        th += alpha * lp_lb if alpha > 0.0 else 0.0
        th += (1.0 - alpha) * (merge_lb + train_lb) if alpha < 1.0 else 0.0
        if best_sc <= th:
            break

    return SearchResult(best_plan, best_sc, alpha, n_scored=len(scored),
                        n_generated=bfs.n_generated + tl.n_generated,
                        n_layers=n_layers,
                        elapsed_s=time.perf_counter() - t0,
                        method="PSOA" if alpha != 0.0 else "PSOA(a0)",
                        ir=lower(best_plan, query, index))


SEARCHERS = {
    "nai": lambda m, q, i, c, a: nai_search(m, q, i, c, a),
    "gra": lambda m, q, i, c, a: gra_search(m, q, i, c),
    "psoa": lambda m, q, i, c, a: psoa_search(m, q, i, c, a, use_plus=False),
    "psoa++": lambda m, q, i, c, a: psoa_search(m, q, i, c, a, use_plus=True),
}
