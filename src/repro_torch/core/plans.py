"""Interval algebra + candidate-plan generation (paper §V.B.3).

A *plan* for query range Q is a set of pairwise-disjoint materialized
models whose ranges are contained in Q, plus the implicit "train the
uncovered remainder" step.  *RL plans* ("relatively longest") are the
maximal such sets — every other candidate plan is obtained by removing
models from some RL plan (Theorem 1), which makes them the roots of the
hierarchical plan search.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple


@dataclass(frozen=True, order=True)
class Interval:
    lo: float
    hi: float

    def __post_init__(self):
        if self.hi < self.lo:
            raise ValueError(f"bad interval [{self.lo}, {self.hi})")

    @property
    def length(self) -> float:
        return self.hi - self.lo

    def contains(self, other: "Interval") -> bool:
        return self.lo <= other.lo and other.hi <= self.hi

    def overlaps(self, other: "Interval") -> bool:
        return self.lo < other.hi and other.lo < self.hi

    def intersect(self, other: "Interval") -> "Interval | None":
        lo, hi = max(self.lo, other.lo), min(self.hi, other.hi)
        return Interval(lo, hi) if lo < hi else None


def union_length(intervals: Iterable[Interval]) -> float:
    total, end = 0.0, float("-inf")
    for iv in sorted(intervals):
        lo = max(iv.lo, end)
        if iv.hi > lo:
            total += iv.hi - lo
            end = iv.hi
        end = max(end, iv.hi)
    return total


def subtract(universe: Interval, pieces: Sequence[Interval]) -> List[Interval]:
    """universe minus the union of pieces — the *uncovered* ranges."""
    out: List[Interval] = []
    cursor = universe.lo
    for iv in sorted(pieces):
        lo = max(iv.lo, universe.lo)
        hi = min(iv.hi, universe.hi)
        if hi <= lo:
            continue
        if lo > cursor:
            out.append(Interval(cursor, lo))
        cursor = max(cursor, hi)
    if cursor < universe.hi:
        out.append(Interval(cursor, universe.hi))
    return out


def intersect_lists(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for x in a:
        for y in b:
            z = x.intersect(y)
            if z is not None:
                out.append(z)
    return sorted(out)


# ---------------------------------------------------------------------------
# candidate plans
# ---------------------------------------------------------------------------

def usable(models: Sequence, query: Interval) -> List:
    """Materialized models whose range is contained in the query range."""
    return [m for m in models if query.contains(m.o)]


def _disjoint(ivs: Sequence[Interval]) -> bool:
    s = sorted(ivs)
    return all(s[i].hi <= s[i + 1].lo for i in range(len(s) - 1))


def all_plans(models: Sequence, query: Interval) -> List[Tuple]:
    """Every candidate plan (all antichains of usable models), incl. {}.

    Exponential — this is the NAI baseline's generator.
    """
    cand = sorted(usable(models, query), key=lambda m: (m.o.lo, m.o.hi))
    plans: List[Tuple] = [()]
    for m in cand:
        new = []
        for p in plans:
            if all(not m.o.overlaps(x.o) for x in p):
                new.append(p + (m,))
        plans.extend(new)
    return plans


def rl_plans(models: Sequence, query: Interval) -> List[Tuple]:
    """All *maximal* antichains of usable models (Theorem 1 roots).

    Left-to-right enumeration: a disjoint set, listed in sorted order, is
    maximal iff no candidate fits wholly inside any unchosen gap.  Each
    maximal set is produced exactly once (its sorted order is unique).
    """
    cand = sorted(usable(models, query), key=lambda m: (m.o.lo, m.o.hi))
    if not cand:
        return [()]
    results: List[Tuple] = []

    def extend(chosen: Tuple, end: float) -> None:
        nxt = [m for m in cand if m.o.lo >= end]
        if not nxt:
            results.append(chosen)
            return
        for m in nxt:
            # choosing m next strands any candidate wholly inside the
            # gap [end, m.lo) — that set would not be maximal.
            if any(c is not m and c.o.hi <= m.o.lo for c in nxt):
                continue
            extend(chosen + (m,), m.o.hi)

    extend((), float("-inf"))
    return results


def children(plan: Tuple) -> List[Tuple]:
    """All plans obtained by removing exactly one model (plan-tree edge)."""
    return [plan[:i] + plan[i + 1 :] for i in range(len(plan))]


def plan_key(plan: Tuple) -> Tuple:
    return tuple(sorted(m.model_id for m in plan))
