"""Entry ``service_explore``: analysts pan and zoom over the capital
through ``MLegoService.submit``, each in a closed loop.

Set-up makes the corpus and the capital (one stored model a leaf of
``leaf_units``, its statistic counted from the leaf's own tokens),
frees the card of the generator's work, builds the service over a
``DeviceBackend`` whose LRU holds the whole capital, warms the LRU, and
runs ``warmup_queries`` queries of a stream of their own through the
same loop.

The window is a closed loop with zero think time: each of ``analysts``
analysts (one tenant each) sends its first query when the window opens
and its next one as soon as its answer arrives, until ``--seconds``
have passed; the queries still in flight then are waited for.  Every
query is covered by stored leaves (``bench/traffic/explore.py``).  The
rate reported is the answers that came back by the last answer inside
the window, over the time to that answer.

The client keeps the program's beta only for the answers the check
reads, chosen from the seed before the window: ``check_answers`` of the
window's first ``check_from`` queries, and the first answer of the
widest level.

Workload keys: ``analysts``, ``widths_leaves``, ``alpha``,
``materialize``, ``service`` (keyword arguments of ``MLegoService``
beyond its defaults), ``warmup_queries``, ``check_answers``,
``check_from``, ``limits``.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np

from bench.costs import kernels as costs
from bench.devtrace.window import DeviceWindow
from bench.entries.common import (Ctx, Outcome, TraceCtx, generate, judge,
                                  lda_config, peak_bytes, program_corpus,
                                  release, reset_peak)
from bench.entries.service_submit import STAT_KEY, Answer, rate_to_last
from bench.reference import vb_merge
from bench.traffic.corpus import capital_stat, leaves
from bench.traffic.explore import explore_queries, n_leaves
from bench.traffic.queries import sub_seed

# the longest the loop waits for any answer before it gives up
STALL_S = 600.0


class Collector:
    """Reduces each answer on arrival (in the worker thread that resolves
    it) and hands its analyst back to the loop.  Keeps beta for the
    indices in ``picks`` and for the first answer of ``widest`` leaves."""

    def __init__(self, leaf_of: dict, leaf_units: float, picks=(),
                 widest: int = 0):
        self.leaf_of, self.leaf_units = leaf_of, leaf_units
        self.picks, self.widest = set(picks), widest
        self.ready: "queue.SimpleQueue[int]" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self.widest_answer: Optional[Answer] = None
        self.fallbacks = 0

    def done(self, ans: Answer, fut) -> None:
        try:
            ans.t_answer = time.perf_counter()
            ans.future = None
            try:
                self._reduce(ans, fut.result())
            except Exception as exc:    # the query's, or an unreadable one
                ans.state, ans.error = "failed", exc
        finally:
            self.ready.put(ans.analyst)

    def _reduce(self, ans: Answer, rep) -> None:
        ans.n_merged = rep.n_merged
        # a model the benchmark did not store covers nothing
        ans.fetched = tuple(self.leaf_of.get(f.model_id, (0.0, 0.0))
                            for plan in rep.plans for f in plan.ir.fetches)
        ans.gaps = tuple((s.gap.lo, s.gap.hi)
                         for plan in rep.plans for s in plan.ir.gaps)
        keep = ans.index in self.picks
        with self._lock:
            if getattr(rep, "fallback_from", None) is not None:
                self.fallbacks += 1
            width = round((ans.hi - ans.lo) / self.leaf_units)
            if self.widest_answer is None and width == self.widest:
                self.widest_answer = ans
                keep = True
        if keep:
            ans.beta = rep.beta
        ans.state = "answered"


def closed_loop(svc, ctx: Ctx, tag: str, collector: Collector,
                leaves_n: int, *, until: Optional[float] = None,
                count: Optional[int] = None) -> List[Answer]:
    """Each analyst sends its next query when its answer arrives, until
    ``until`` (host clock) or ``count`` queries in all; returns the
    queries sent, every one of them answered or failed."""
    from repro_torch.api.spec import QuerySpec
    from repro_torch.core.plans import Interval

    wl = ctx.workload
    n = int(wl["analysts"])
    streams = [explore_queries(wl, leaves_n, ctx.config["capital"]
                               ["leaf_units"], ctx.seed, a, tag)
               for a in range(n)]
    sent: List[Answer] = []

    def send(a: int) -> None:
        lo, hi = next(streams[a])
        spec = QuerySpec(sigma=Interval(lo, hi), alpha=wl["alpha"],
                         materialize=wl["materialize"])
        now = time.perf_counter()
        ans = Answer(len(sent), a, lo, hi, now, now)
        sent.append(ans)
        ans.future = svc.submit(spec, tenant=f"analyst-{a}")
        ans.future.add_done_callback(
            lambda f, ans=ans: collector.done(ans, f))

    def more() -> bool:
        return ((count is None or len(sent) < count)
                and (until is None or time.perf_counter() < until))

    in_flight = 0
    for a in range(n):
        if more():
            send(a)
            in_flight += 1
    while in_flight:
        try:
            a = collector.ready.get(timeout=STALL_S)
        except queue.Empty:
            raise RuntimeError(f"no answer for {STALL_S:.0f}s with "
                               f"{in_flight} queries in flight") from None
        in_flight -= 1
        if more():
            send(a)
            in_flight += 1
    return sent


def build(ctx: Ctx):
    """Corpus, capital and the service over it, the LRU warmed.
    Returns (corpus, {model id: leaf}, service, backend, tracer)."""
    from repro_torch.api.backend import DeviceBackend
    from repro_torch.core.plans import Interval
    from repro_torch.core.store import ModelStore
    from repro_torch.obs.trace import Tracer
    from repro_torch.serve.service import MLegoService

    cfg, dev = ctx.config, ctx.device
    kind = cfg["kind"]
    g = generate(ctx)
    release(dev)                  # the generator's work, before the capital
    store = ModelStore()
    leaf_of = {}
    for lo, hi in leaves(cfg["corpus"]["attr_max"],
                         cfg["capital"]["leaf_units"]):
        d0, d1 = g.docs_in(lo, hi)
        if d1 > d0:
            t0, t1 = g.tokens_in(lo, hi)
            m = store.add(Interval(lo, hi), d1 - d0, t1 - t0, kind,
                          {STAT_KEY[kind]: capital_stat(
                              g, lo, hi, kind, cfg["lda"]["eta"], dev)})
            leaf_of[m.model_id] = (lo, hi)
    ctx.log(f"corpus: {g.n_docs} docs, {g.n_tokens} tokens; "
            f"capital: {len(store)} models, {store.nbytes()} bytes")
    tracer = Tracer(capacity=1 << 20, enabled=ctx.trace)
    backend = DeviceBackend(capacity=cfg["backend"]["capacity"], device=dev,
                            profile=ctx.trace)
    svc = MLegoService(program_corpus(g), lda_config(ctx), store=store,
                       kind=kind, backend=backend, cost="analytic",
                       seed=sub_seed(ctx.seed, "program"), tracer=tracer,
                       device=dev, **ctx.workload.get("service", {}))
    # bound first: a tenant session's first bind of the store would
    # clear the LRU, and the capital would be uploaded again as misses
    backend.bind_store(store)
    for m in store.models():
        backend.note_trained(m)          # the LRU holds the capital
    return g, leaf_of, svc, backend, tracer


def _parts_merged(backend) -> Optional[int]:
    """The backend's count of parts merged (None where it keeps none)."""
    return getattr(backend.stats, "merge_parts", None)


def run(ctx: Ctx) -> Outcome:
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    lda_cfg = cfg["lda"]
    k, v = lda_cfg["n_topics"], lda_cfg["vocab_size"]
    leaf = cfg["capital"]["leaf_units"]
    leaves_n = n_leaves(cfg["corpus"]["attr_max"], leaf)
    g, leaf_of, svc, backend, tracer = build(ctx)
    rng = np.random.default_rng(sub_seed(ctx.seed, "check"))
    picks = rng.choice(int(wl["check_from"]), size=int(wl["check_answers"]),
                       replace=False)
    widest = max(int(w) for w in wl["widths_leaves"])
    try:
        warm = closed_loop(svc, ctx, "warmup", Collector(leaf_of, leaf),
                           leaves_n, count=wl["warmup_queries"])
        bad = [a.error for a in warm if a.error is not None]
        if bad:
            raise RuntimeError(f"warm-up query failed: {bad[0]!r}")
        setup_s = time.perf_counter() - ctx.t_start
        ctx.log(f"set-up {setup_s:.2f}s; window of {ctx.seconds}s")

        reset_peak(dev)
        parts_before = _parts_merged(backend)
        groups_before = svc.report()
        dw = DeviceWindow(dev, ctx.trace)
        dw.start()
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        collector = Collector(leaf_of, leaf, picks, widest)
        sent = closed_loop(svc, ctx, "window", collector, leaves_n,
                           until=deadline)
        device_trace = dw.stop()
        memory_peak = peak_bytes(dev)
        parts_after = _parts_merged(backend)
        groups_after = svc.report()
    finally:
        svc.close()

    ok = [a for a in sent if a.error is None]
    n_in, span_s = rate_to_last(sent, t0, deadline)
    qps = n_in / span_s if span_s > 0 else 0.0
    failed = len(sent) - len(ok)
    ctx.log(f"{len(sent)} sent; {n_in} answered in {span_s:.3f}s "
            f"({qps:.3f}/s), {failed} failed, {collector.fallbacks} "
            f"answered after a fallback; peak {memory_peak} bytes")
    for a in sent:
        if a.error is not None:
            ctx.log(f"failed: [{a.lo}, {a.hi}): {a.error!r}")

    trace = None
    if ctx.trace:
        counters = {
            "groups": groups_after.groups - groups_before.groups,
            "width_sum": groups_after.width_sum - groups_before.width_sum}
        if parts_before is not None and parts_after is not None:
            counters["merge_parts"] = parts_after - parts_before
        trace = TraceCtx(
            device=device_trace, spans=[s for s in tracer.spans()
                                        if s.t0 >= t0],
            latencies=[a.t_answer - a.t_sent for a in ok],
            work={"merge": [costs.merge(a.n_merged, k, v) for a in ok]},
            counters=counters, answered=len(ok))

    sample = [{"sigma": (a.lo, a.hi), "beta": a.beta, "fetched": a.fetched}
              for a in ok if a.beta is not None]
    attempted = len(sent)
    del svc, backend, sent, ok, warm, collector
    release(dev)

    t_ref = time.perf_counter()
    numbers = vb_merge.vb_answers(g, sample, lda_cfg["eta"], dev)
    ctx.log(f"reference over {len(sample)} answers: "
            f"{time.perf_counter() - t_ref:.2f}s")
    return Outcome(setup_s=setup_s, e2e={"queries_per_s": qps},
                   attempted=attempted, failed=failed,
                   checks=judge(numbers, wl["limits"]),
                   memory_peak_bytes=memory_peak, trace=trace)
