"""Executor internals — the Fig. 2 "gap training" + "merge" stages.

One trainer body for every model kind (via the trainer registry) and
one materialization switch, replacing the seed repo's four copy-pasted
``train_range`` / ``_train_volatile`` bodies.  ``persist=True`` adds
the fresh model to the store (the reuse-capital flywheel);
``persist=False`` returns an unregistered model (id −1) and leaves the
store untouched.

Both stages execute through a pluggable ``ExecutionBackend``
(``repro_torch.api.backend``): the host backend preserves the seed's NumPy
semantics; the device backend runs merges as CUDA kernel launches
over a device-resident model cache and routes VB gap training through
the fused E-step kernel.  A
persisted gap model is handed back to the backend (``note_trained``)
so device backends can warm their cache with it before the merge that
follows.  ``backend=None`` falls back to host semantics so direct
callers (tests, schedulers) need no wiring.  ``gather`` returns one
measured ``(tokens, seconds, device_seconds)`` sample per trained gap —
the session feeds these to the cost provider keyed by the backend that
ran them, which is how host and device κ are calibrated separately,
and sums the device component into the *per-query*
``train_device_ms`` (attribution by the query's own wall clock, not a
shared counter diff, so concurrent sessions on one backend can't
claim each other's kernel time).

Every stage emits spans through the ambient tracing context
(``repro_torch.obs.trace``): ``fetch`` around the store reads, ``train``
per gap, ``merge`` around the backend merge.  With no enclosing span
(bare executor use) these are no-ops.

The executor consumes the planner's **Plan IR** (``repro_torch.core.plan_ir``):
``gather`` walks a ``Plan``'s ``FetchStep``/``TrainGapStep`` sequence —
resolving fetched model ids against the store and training each gap —
and returns the homogeneous part list the ``MergeStep`` combines,
plus per-gap (tokens, seconds) training observations for cost-provider
calibration.
"""
from __future__ import annotations

import inspect
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.backend import ExecutionBackend, HostBackend
from repro_torch.api.trainers import get_trainer, merge_family_name, resolve_kind
from repro_torch.configs.lda_default import LDAConfig
from repro_torch.core.errors import (DeviceLostError, RetryPolicy,
                               TransientExecutionError)
from repro_torch.core.lda import MaterializedModel
from repro_torch.core.plan_ir import Plan
from repro_torch.core.plans import Interval
from repro_torch.core.store import ModelStore
from repro_torch.data.corpus import Corpus
from repro_torch.obs import trace as obs
from repro_torch.testing.faults import maybe_fail


class StalePlanError(KeyError, TransientExecutionError):
    """A plan's fetched model vanished from the store between planning
    and execution — background compaction/eviction (``repro_torch.ingest``)
    removed it mid-query.  The store mutation already invalidated the
    plan cache, so a re-plan over the current model set succeeds;
    ``MLegoSession.submit`` re-plans on this (transient in the
    taxonomy, but a blind same-plan retry can never succeed — callers
    must re-plan, so the executor's own retry loop excludes it)."""


def _resolves_to(tag: str, kind: str) -> bool:
    """Store tags may be aliases ("gibbs") or foreign kinds entirely."""
    try:
        return resolve_kind(tag) == kind
    except ValueError:
        return tag == kind


def _accepts_global_nkv(trainer) -> bool:
    """Trainer registry signatures are (corpus, cfg, gen); the DSGS
    prior reaches only Gibbs-family trainers that declare the keyword —
    other trainers keep the plain contract untouched."""
    try:
        return "global_nkv" in inspect.signature(trainer).parameters
    except (TypeError, ValueError):
        return False


def _parts_kind(parts: Sequence[MaterializedModel]) -> str:
    """Single canonical kind of a homogeneous part list (validated).

    Kinds are compared after alias resolution, so legacy stores tagged
    "gibbs" merge with fresh "gs" models."""
    if not parts:
        raise ValueError("nothing to merge")
    kinds = {resolve_kind(m.kind) for m in parts}
    if len(kinds) != 1:
        raise ValueError(f"cannot merge mixed kinds {kinds}")
    return kinds.pop()


class Executor:
    def __init__(self, corpus: Corpus, cfg: LDAConfig, store: ModelStore,
                 next_gen: Callable[[], torch.Generator],
                 retry: Optional[RetryPolicy] = None):
        self.corpus = corpus
        self.cfg = cfg
        # (kind, frozenset(model ids), summed ΔN_kv) — see _gs_prior.
        # Keyed by id set, which is unambiguous only within one store
        # (ids are never reused there) — so a store swap must drop it.
        self._gs_prior_memo = None
        self.store = store
        self._next_gen = next_gen
        self._host = HostBackend()
        # One policy object for every data-plane call this executor
        # makes (fetch, train, merge); the session/service surface its
        # per-site counters in reports.
        self.retry = retry if retry is not None else RetryPolicy()

    @property
    def store(self) -> ModelStore:
        return self._store

    @store.setter
    def store(self, v: ModelStore) -> None:
        self._store = v
        self._gs_prior_memo = None

    def train_gap(self, lo: float, hi: float, kind: str,
                  *, persist: bool = True,
                  backend: Optional[ExecutionBackend] = None,
                  next_gen: Optional[Callable[[], torch.Generator]] = None
                  ) -> Optional[MaterializedModel]:
        """Train one fresh model on [lo, hi); None if the range is empty.

        For Gibbs-family kinds the store's merged counts ride along as
        the DSGS ``global_nkv`` prior (Eq. 8): the gap samples against
        the reuse capital's topic structure instead of the zero prior
        the seed used, so fresh gap topics align with the models they
        are about to be merged with.  (The trained model still carries
        only its *own* token counts — the prior shapes the conditional,
        it is never added to ΔN_kv — so merges don't double count.)

        ``next_gen`` overrides the executor's generator supplier for this one
        training call — the serving layer passes the *owning tenant's*
        stream when it trains shared segments of a coalesced group, so
        a tenant's results don't depend on which neighbors it fused
        with.
        """
        d0, d1 = self.corpus.doc_slice(lo, hi)
        if d1 <= d0:
            return None
        kind = resolve_kind(kind)
        sub = self.corpus.subset(lo, hi)
        trainer = backend.trainer(kind) if backend is not None \
            else get_trainer(kind)
        kwargs = {}
        if merge_family_name(kind) == "gs" and _accepts_global_nkv(trainer):
            prior = self._gs_prior(kind)
            if prior is not None:
                kwargs["global_nkv"] = prior
        gen = (next_gen or self._next_gen)()
        site = "backend.train_gap." + (backend.name if backend is not None
                                       else "host")

        def _train():
            maybe_fail(site)
            return trainer(sub, self.cfg, gen, **kwargs)

        # Device loss is excluded: a blind retry would hit the same
        # dead device — the session replays on the fallback chain.
        with obs.span("train", "exec", lo=lo, hi=hi, kind=kind,
                      backend=(backend.name if backend else "host"),
                      tokens=sub.n_tokens):
            theta = self.retry.run(_train, site=site,
                                   no_retry=(DeviceLostError,))
        if persist:
            m = self.store.add(Interval(lo, hi), sub.n_docs, sub.n_tokens,
                               kind, theta)
            if backend is not None:
                # warm the backend's device cache with the fresh model —
                # the merge right after this will read it back
                backend.note_trained(m)
            return m
        return MaterializedModel(-1, Interval(lo, hi), sub.n_docs,
                                 sub.n_tokens, kind, theta)

    def _gs_prior(self, kind: str) -> Optional[np.ndarray]:
        """Σ ΔN_kv over the store's models of ``kind`` — the global
        topic-word counts a DSGS step conditions on.  None when the
        store holds no usable counts (cold store: zero prior, exactly
        the seed behavior).

        Memoized on the eligible model-id set: a submit_many segment
        loop persists one gap per segment, so the common transition is
        "same set plus a few fresh ids" — extended incrementally with
        just the new deltas instead of re-summing the whole store's
        (K, V) arrays per trained gap."""
        eligible = {
            m.model_id: m for m in self.store.models()
            if "delta_nkv" in m.theta and _resolves_to(m.kind, kind)
            and m.theta["delta_nkv"].shape == (self.cfg.n_topics,
                                               self.cfg.vocab_size)}
        if not eligible:
            self._gs_prior_memo = None
            return None
        ids = frozenset(eligible)
        memo = self._gs_prior_memo
        if memo is not None and memo[0] == kind:
            _, mids, mval = memo
            if mids == ids:
                return mval
            if mids < ids:
                val = mval + np.sum(
                    [np.asarray(eligible[i].theta["delta_nkv"], np.float32)
                     for i in ids - mids], axis=0, dtype=np.float32)
                self._gs_prior_memo = (kind, ids, val)
                return val
        val = np.sum(
            [np.asarray(m.theta["delta_nkv"], np.float32)
             for m in eligible.values()], axis=0, dtype=np.float32)
        self._gs_prior_memo = (kind, ids, val)
        return val

    def gather(self, plan: Plan, kind: str, *, persist: bool = True,
               backend: Optional[ExecutionBackend] = None
               ) -> Tuple[List[MaterializedModel],
                          List[MaterializedModel],
                          int, List[Tuple[int, float, float]]]:
        """Consume one Plan IR's fetch + train-gap steps.

        Returns ``(parts, fresh, n_trained_tokens, train_obs)``:
        ``parts`` is everything the plan's merge step will combine —
        fetched store models (resolved by id) followed by freshly
        trained gap models — ``fresh`` the trained subset, and
        ``train_obs`` one measured ``(tokens, seconds,
        device_seconds)`` sample per trained gap: ``seconds`` is the
        κ input for the calibrated cost provider, ``device_seconds``
        equals it when the backend routed this kind through a device
        kernel (``backend.kernel_route``) and is 0.0 on host routes —
        the per-query ``train_device_ms`` attribution.
        """
        def _fetch_parts() -> List[MaterializedModel]:
            try:
                return [self.store.get(f.model_id) for f in plan.fetches]
            except StalePlanError:
                raise
            except KeyError as exc:
                raise StalePlanError(
                    f"planned model {exc.args[0]!r} was removed from the "
                    f"store (background compaction/eviction?)") from exc

        # store.get faults (injected or real I/O hiccups) retry in
        # place; a StalePlanError propagates — only a re-plan helps.
        with obs.span("fetch", "exec", n_fetches=len(plan.fetches)):
            parts = self.retry.run(_fetch_parts, site="store.get",
                                   no_retry=(StalePlanError,))
            obs.set_attrs(bytes=sum(p.nbytes() for p in parts))
        kernel_route = backend is not None and backend.kernel_route(kind)
        fresh: List[MaterializedModel] = []
        n_tok = 0
        samples: List[Tuple[int, float, float]] = []
        for g in plan.gaps:
            t0 = time.perf_counter()
            m = self.train_gap(g.gap.lo, g.gap.hi, kind,
                               persist=persist, backend=backend)
            if m is not None:
                dt = time.perf_counter() - t0
                fresh.append(m)
                parts.append(m)
                n_tok += m.n_tokens
                samples.append((m.n_tokens, dt, dt if kernel_route else 0.0))
        return parts, fresh, n_tok, samples

    def merge(self, parts: Sequence[MaterializedModel],
              backend: Optional[ExecutionBackend] = None) -> np.ndarray:
        """Merge a homogeneous part list -> β (K, V), dispatching to the
        kind's merge family (Alg. 1 for vb, Alg. 2 for gs) on the given
        execution backend (host semantics when None)."""
        kind = _parts_kind(parts)
        b = backend or self._host
        with obs.span("merge", "exec", n_parts=len(parts), kind=kind,
                      backend=b.name):
            return self.retry.run(
                lambda: b.merge(list(parts), kind, self.cfg),
                site=f"backend.merge.{b.name}", no_retry=(DeviceLostError,))

    def merge_many(self, part_lists: Sequence[Sequence[MaterializedModel]],
                   backend: Optional[ExecutionBackend] = None
                   ) -> List[np.ndarray]:
        """Merge several plans at once (the submit_many hot path).

        All lists must share one kind; the device backend turns the
        whole batch into a single padded kernel launch."""
        kinds = {_parts_kind(p) for p in part_lists}
        if len(kinds) != 1:
            raise ValueError(f"cannot batch-merge mixed kinds {kinds}")
        kind = kinds.pop()
        b = backend or self._host
        with obs.span("merge", "exec", n_plans=len(part_lists),
                      n_parts=sum(len(p) for p in part_lists), kind=kind,
                      backend=b.name):
            return self.retry.run(
                lambda: b.merge_many([list(p) for p in part_lists], kind,
                                     self.cfg),
                site=f"backend.merge.{b.name}", no_retry=(DeviceLostError,))
