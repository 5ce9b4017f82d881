"""Typed analytic-query specification — the paper's Def. 1 made concrete.

Def. 1 defines an analytic query as the five-tuple q = {F, α, D, σ, M}:

  F : the analysis function (LDA here) — fixed by the session's
      ``LDAConfig`` + the trainer ``kind`` (see ``repro_torch.api.trainers``)
  α : the accuracy/latency preference in [0, 1] (Eq. 2 weight)
  D : the dataset — owned by the session (``MLegoSession.corpus``)
  σ : the range predicate over the ordered dimension attribute —
      a single ``Interval`` or a **union of intervals**
  M : whether the answer's fresh gap models are materialized back into
      the store — the ``materialize`` policy (``persist``/``volatile``)

``QuerySpec`` carries the per-query members (σ, α, trainer kind,
plan-search method, materialization policy, execution backend); the
session carries F and D.  Specs are frozen, validated at construction,
and normalize σ into a sorted tuple of disjoint intervals (overlapping
or touching member intervals are coalesced), so everything downstream
can assume a clean predicate.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Tuple, Union

from repro_torch.api.backend import BACKEND_NAMES
from repro_torch.core.plans import Interval
from repro_torch.core.search import SEARCHERS

PERSIST = "persist"
VOLATILE = "volatile"
MATERIALIZE_POLICIES = (PERSIST, VOLATILE)

Sigma = Union[Interval, Iterable[Interval]]


def normalize_sigma(sigma: Sigma) -> Tuple[Interval, ...]:
    """σ -> sorted tuple of disjoint, positive-length intervals.

    Accepts a single ``Interval`` or any iterable of them; coalesces
    overlapping *and* touching members (they select the same documents
    as their union).  Raises ``ValueError`` on empty predicates.
    """
    ivs = [sigma] if isinstance(sigma, Interval) else list(sigma)
    if not ivs:
        raise ValueError("predicate sigma selects no range (empty union)")
    for iv in ivs:
        if not isinstance(iv, Interval):
            raise TypeError(f"sigma members must be Interval, got {type(iv)}")
        if iv.length <= 0:
            raise ValueError(f"sigma member {iv} has zero length")
    out = []
    for iv in sorted(ivs):
        if out and iv.lo <= out[-1].hi:
            out[-1] = Interval(out[-1].lo, max(out[-1].hi, iv.hi))
        else:
            out.append(iv)
    return tuple(out)


@dataclass(frozen=True)
class QuerySpec:
    """One analytic query (Def. 1's per-query members, typed + validated).

    sigma       : predicate σ — Interval or union of Intervals
                  (normalized to a disjoint sorted tuple)
    alpha       : α ∈ [0, 1] — 0 = fastest, 1 = most accurate (Eq. 2)
    kind        : trainer/backend kind ("vb", "gs"/"gibbs", or any
                  registered kind); canonicalized through the registry.
                  None (the default) means "use the session's kind".
    method      : plan-search algorithm ("nai" | "gra" | "psoa" |
                  "psoa++")
    materialize : M — "persist" grows the store with fresh gap models,
                  "volatile" answers without touching the store
    backend     : execution backend for merge + gap training —
                  "host" (NumPy) or "device" (CUDA kernels with a
                  device-resident model cache).  None (the default)
                  means "use the session's backend".
    """

    sigma: Tuple[Interval, ...]
    alpha: float = 0.0
    kind: Optional[str] = None
    method: str = "psoa++"
    materialize: str = PERSIST
    backend: Optional[str] = None

    def __post_init__(self):
        from repro_torch.api.trainers import resolve_kind  # late: registry may grow
        object.__setattr__(self, "sigma", normalize_sigma(self.sigma))
        if not 0.0 <= self.alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {self.alpha}")
        if self.kind is not None:
            object.__setattr__(self, "kind", resolve_kind(self.kind))
        if self.method not in SEARCHERS:
            raise ValueError(f"unknown plan-search method {self.method!r}; "
                             f"one of {sorted(SEARCHERS)}")
        if self.materialize not in MATERIALIZE_POLICIES:
            raise ValueError(f"materialize must be one of "
                             f"{MATERIALIZE_POLICIES}, got {self.materialize!r}")
        if self.backend is not None and self.backend not in BACKEND_NAMES:
            raise ValueError(f"unknown execution backend {self.backend!r}; "
                             f"one of {BACKEND_NAMES} or None (session's)")

    # --- convenience ----------------------------------------------------
    @property
    def is_union(self) -> bool:
        return len(self.sigma) > 1

    @property
    def span(self) -> Interval:
        """Bounding interval of the predicate (hull of the union)."""
        return Interval(self.sigma[0].lo, self.sigma[-1].hi)

    @property
    def persist(self) -> bool:
        return self.materialize == PERSIST
