"""DEPRECATED query facade — use ``repro_torch.api.MLegoSession`` instead.

The canonical implementation of the Fig. 2 pipeline (plan search ->
gap training -> merge) lives in ``repro_torch.api`` (session / planner /
executor).  ``QueryEngine`` is a *thin alias* over ``MLegoSession``,
kept as the JAX package keeps it, so old call sites fail
loudly-but-gracefully:

  * construction warns ``DeprecationWarning`` and builds the session
  * ``execute(sigma, alpha, method)`` -> ``submit(QuerySpec(...))``,
    returning the ``QueryReport``
  * ``execute_batch(sigmas)`` -> ``submit_many([...])``, returning
    ``(reports, opt)`` — shared search/train costs live on the
    ``BatchReport`` (``last_batch_report``)

Like the session, it runs on ``device`` ("cuda" unless the caller asks
for the CPU).
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.api.reports import BatchReport, QueryReport
from repro_torch.api.session import MLegoSession
from repro_torch.api.spec import PERSIST, VOLATILE, QuerySpec
from repro_torch.configs.lda_default import LDAConfig
from repro_torch.core.batch_opt import BatchResult
from repro_torch.core.cost import CostModel
from repro_torch.core.plans import Interval
from repro_torch.core.store import ModelStore
from repro_torch.data.corpus import Corpus


class QueryEngine(MLegoSession):
    """Deprecated positional-argument alias of ``MLegoSession``."""

    def __init__(self, corpus: Corpus, store: ModelStore, cfg: LDAConfig,
                 cost: Optional[CostModel] = None, kind: str = "vb",
                 *, materialize_results: bool = True, seed: int = 0,
                 device: Union[str, torch.device, None] = "cuda"):
        warnings.warn(
            "QueryEngine is deprecated; use repro_torch.api.MLegoSession."
            "submit with a QuerySpec", DeprecationWarning, stacklevel=2)
        super().__init__(corpus, cfg, store=store, cost=cost, kind=kind,
                         seed=seed, device=device)
        self.materialize_results = materialize_results
        self.last_batch_report: Optional[BatchReport] = None

    def _spec(self, sigma, alpha: float, method: str = "psoa++") -> QuerySpec:
        return QuerySpec(sigma=sigma, alpha=alpha, kind=self.kind,
                         method=method,
                         materialize=PERSIST if self.materialize_results
                         else VOLATILE)

    def execute(self, sigma: Interval, alpha: float,
                method: str = "psoa++") -> QueryReport:
        """One analytic query: search, train gaps, merge."""
        return self.submit(self._spec(sigma, alpha, method))

    def execute_batch(self, sigmas: Sequence[Interval]
                      ) -> Tuple[List[QueryReport], BatchResult]:
        """§V.C batch path: Alg. 4 plan combination, shared gap training."""
        br = self.submit_many([self._spec(s, 0.0) for s in sigmas])
        self.last_batch_report = br
        return list(br.reports), br.opt


__all__ = ["QueryEngine"]
