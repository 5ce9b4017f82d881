"""Plan IR — the typed execution plan behind every query (Fig. 2).

The searchers (§V.B), the batch optimizer (§V.C) and the session
planner all answer the same question — *how* to materialize β for a
predicate σ — and before this module they answered it with a bare
tuple of ``MaterializedModel``s, leaving the training/merge structure
implicit for the executor to re-derive.  The IR makes the full plan
first-class: a ``Plan`` is an ordered tuple of typed steps

  ``FetchStep``    bring one materialized model's Θ to the execution
                   backend (a device-cache hit costs ~0, a miss pays
                   the host→device transfer)
  ``TrainGapStep`` fit a fresh model on one uncovered range
  ``MergeStep``    combine every fetched + fresh part into β (Alg. 1/2)

so cost providers can price exactly what the backend will do (see
``repro_torch.core.cost``), the session can cache plans by value, and the
executor consumes steps instead of re-deriving gaps from model tuples.

Steps reference store models by id (plans stay light and hashable);
the executor resolves ids against the session's ``ModelStore`` at
execution time.  A plan is immutable and order-normalized: fetches
sorted by range start, then gaps sorted likewise, then the single
merge step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple, Union

from repro_torch.core.plans import Interval, subtract


@dataclass(frozen=True)
class FetchStep:
    """Fetch one materialized model's Θ onto the execution backend."""

    model_id: int
    o: Interval                 # range the model covers
    n_tokens: int               # data volume behind the model


@dataclass(frozen=True)
class TrainGapStep:
    """Train a fresh model on one uncovered range of σ."""

    gap: Interval
    n_tokens: int               # tokens the trainer will see (may be 0)


@dataclass(frozen=True)
class MergeStep:
    """Merge all fetched + freshly trained parts into β."""

    n_parts: int                # planned part count (fetches + nonempty gaps)


PlanStep = Union[FetchStep, TrainGapStep, MergeStep]


@dataclass(frozen=True)
class Plan:
    """One query component's execution plan: fetches, gaps, one merge."""

    sigma: Interval
    steps: Tuple[PlanStep, ...] = ()

    # --- step views -------------------------------------------------------
    @property
    def fetches(self) -> Tuple[FetchStep, ...]:
        return tuple(s for s in self.steps if isinstance(s, FetchStep))

    @property
    def gaps(self) -> Tuple[TrainGapStep, ...]:
        return tuple(s for s in self.steps if isinstance(s, TrainGapStep))

    @property
    def merge(self) -> MergeStep:
        return next(s for s in reversed(self.steps)
                    if isinstance(s, MergeStep))

    # --- the quantities cost providers price ------------------------------
    @property
    def model_ids(self) -> Tuple[int, ...]:
        return tuple(sorted(f.model_id for f in self.fetches))

    @property
    def n_models(self) -> int:
        return sum(1 for s in self.steps if isinstance(s, FetchStep))

    @property
    def uncovered_tokens(self) -> float:
        return float(sum(g.n_tokens for g in self.gaps))

    @property
    def n_parts(self) -> int:
        return self.merge.n_parts

    def key(self) -> Tuple:
        """Value identity (used by the session plan cache)."""
        return (self.sigma.lo, self.sigma.hi, self.model_ids,
                tuple((g.gap.lo, g.gap.hi) for g in self.gaps))

    # --- construction ------------------------------------------------------
    @classmethod
    def from_models(cls, models: Sequence, sigma: Interval, index) -> "Plan":
        """Lower a searcher's model set to the typed step sequence.

        ``index`` prices each uncovered gap in tokens; the merge step's
        part count matches what the executor will actually combine
        (every fetch plus every gap that selects data).
        """
        fetches = tuple(
            FetchStep(m.model_id, m.o, int(m.n_tokens))
            for m in sorted(models, key=lambda m: (m.o.lo, m.o.hi)))
        gaps = tuple(
            TrainGapStep(g, int(index.tokens_in(g.lo, g.hi)))
            for g in subtract(sigma, [f.o for f in fetches]))
        n_parts = len(fetches) + sum(1 for g in gaps if g.n_tokens > 0)
        return cls(sigma, fetches + gaps + (MergeStep(n_parts),))


# ---------------------------------------------------------------------------
# batched-launch scheduling math (§V.C) — shared by the batch optimizer's
# padding pricing and the device backend's launch grouping
# ---------------------------------------------------------------------------

def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def size_buckets(part_counts: Sequence[int]) -> dict:
    """Group launch rows by power-of-two part-count bucket.

    Returns ``{bucket_cap: [indices]}``; within a bucket every plan is
    padded only to the bucket's *actual* maximum, so total padding is
    pointwise ≤ the pad-everything-to-the-widest scheme (bucket max ≤
    global max) while compiled batch shapes stay reusable across calls.
    """
    buckets: dict = {}
    for i, n in enumerate(part_counts):
        buckets.setdefault(_next_pow2(max(n, 1)), []).append(i)
    return buckets


def pad_rows_bucketed(part_counts: Sequence[int]) -> int:
    """Zero-weight rows a size-bucketed batched launch carries."""
    total = 0
    for _, idxs in size_buckets(part_counts).items():
        widest = max(part_counts[i] for i in idxs)
        total += sum(widest - part_counts[i] for i in idxs)
    return total


def pad_rows_widest(part_counts: Sequence[int]) -> int:
    """Zero-weight rows the old pad-to-widest single launch carried."""
    if not part_counts:
        return 0
    widest = max(part_counts)
    return sum(widest - n for n in part_counts)
