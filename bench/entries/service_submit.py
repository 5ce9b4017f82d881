"""Entry ``service_submit``: analysts' queries sent to
``MLegoService.submit`` at a fixed rate, over a capital made from the
seed.

Set-up makes the corpus and the capital (one stored model a leaf of
``leaf_units``, its statistic counted from the leaf's own tokens),
builds the service over a ``DeviceBackend`` whose LRU holds the whole
capital, warms the LRU, and sends ``warmup_queries`` queries of a
stream of their own, waiting for every answer.

The window is an open loop: query j is due at j / ``rate_per_s`` after
the window opens, from analyst j mod ``analysts`` (one tenant each),
whatever the answers do.  The rate is set above what the service
sustains, so its queue grows through the window and every group it
drains is as wide as it allows: the rate of answers is its capacity.
Sending stops once ``--seconds`` have passed; queries still queued then
are withdrawn (they are late, not wrong), those running are waited for.
The rate reported is the answers that came back by the last answer
inside the window, over the time to that answer.

Workload keys: ``rate_per_s``, ``analysts``, ``width_min``,
``width_max``, ``alpha``, ``materialize``, ``service`` (keyword
arguments of ``MLegoService`` beyond its defaults), ``warmup_queries``,
``check_answers`` (answers drawn from the seed for the reference,
beside the one whose gaps hold the most tokens), ``limits``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from bench.costs import kernels as costs
from bench.devtrace.window import DeviceWindow
from bench.entries.common import (Ctx, Outcome, TraceCtx, generate, judge,
                                  lda_config, peak_bytes, program_corpus,
                                  release, reset_peak)
from bench.reference import checks
from bench.traffic.corpus import capital_stat, leaves
from bench.traffic.queries import analyst_queries, sub_seed

STAT_KEY = {"vb": "lam", "gs": "delta_nkv"}


@dataclass
class Answer:
    """One sent query, reduced to what the harness reads as it is
    answered: the program's β is kept only for the answers the check may
    draw, so the client holds no more memory than an analyst's would."""

    index: int
    analyst: int
    lo: float
    hi: float
    t_due: float
    t_sent: float
    future: object = None
    t_answer: float = 0.0
    state: str = "sent"             # "answered", "failed" or "withdrawn"
    error: Optional[BaseException] = None
    n_merged: int = 0
    fetched: tuple = ()
    gaps: tuple = ()
    gap_tokens: int = 0
    beta: Optional[np.ndarray] = None


class Collector:
    """Reduces each answer on arrival (in the worker thread that resolves
    it).  Keeps β for one query in ``KEEP_EVERY``, chosen from the seed by
    the query's index, and for the answer whose gaps hold the most tokens
    so far."""

    KEEP_EVERY = 32

    def __init__(self, ctx: Ctx, g, leaf_of: dict):
        self.seed, self.g, self.leaf_of = ctx.seed, g, leaf_of
        self._lock = threading.Lock()
        self.longest: Optional[Answer] = None

    def kept(self, index: int) -> bool:
        return sub_seed(self.seed, f"check{index}") % self.KEEP_EVERY == 0

    def done(self, ans: Answer, fut) -> None:
        ans.t_answer = time.perf_counter()
        ans.future = None
        if fut.cancelled():
            ans.state = "withdrawn"
            return
        try:
            self._reduce(ans, fut.result())
        except Exception as exc:       # the query's, or an unreadable report
            ans.state, ans.error = "failed", exc

    def _reduce(self, ans: Answer, rep) -> None:
        ans.n_merged = rep.n_merged
        # a model the benchmark did not store covers nothing
        ans.fetched = tuple(self.leaf_of.get(f.model_id, (0.0, 0.0))
                            for plan in rep.plans for f in plan.ir.fetches)
        ans.gaps = tuple((s.gap.lo, s.gap.hi)
                         for plan in rep.plans for s in plan.ir.gaps)
        ans.gap_tokens = sum(t1 - t0 for t0, t1 in (
            self.g.tokens_in(lo, hi) for lo, hi in ans.gaps))
        if self.kept(ans.index):
            ans.beta = rep.beta
        with self._lock:
            if self.longest is None \
                    or ans.gap_tokens > self.longest.gap_tokens:
                if self.longest is not None \
                        and not self.kept(self.longest.index):
                    self.longest.beta = None
                self.longest = ans
                ans.beta = rep.beta
        ans.state = "answered"


def open_loop(svc, ctx: Ctx, tag: str, collector: Collector, *,
              until: Optional[float] = None,
              count: Optional[int] = None) -> List[Answer]:
    """Send the analysts' queries at the workload's rate until ``until``
    (host clock) or ``count`` queries; return them as sent."""
    from repro_torch.api.spec import QuerySpec
    from repro_torch.core.plans import Interval

    wl = ctx.workload
    rate, n = float(wl["rate_per_s"]), int(wl["analysts"])
    attr_max = ctx.config["corpus"]["attr_max"]
    streams = [analyst_queries(wl, attr_max, ctx.seed, a, tag)
               for a in range(n)]
    sent: List[Answer] = []
    t_start = time.perf_counter()
    j = 0
    while count is None or j < count:
        due = t_start + j / rate
        if until is not None and due >= until:
            break
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        a = j % n
        lo, hi = next(streams[a])
        spec = QuerySpec(sigma=Interval(lo, hi), alpha=wl["alpha"],
                         materialize=wl["materialize"])
        ans = Answer(j, a, lo, hi, due, time.perf_counter())
        fut = svc.submit(spec, tenant=f"analyst-{a}")
        ans.future = fut
        fut.add_done_callback(lambda f, ans=ans: collector.done(ans, f))
        sent.append(ans)
        j += 1
    return sent


def settle(sent: List[Answer], withdraw: bool) -> List[Answer]:
    """Wait for the sent queries (withdrawing those not yet started, with
    ``withdraw``); return those that ran."""
    if withdraw:
        for a in sent:
            fut = a.future
            if fut is not None:
                fut.cancel()           # only queries still queued
    for a in sent:
        fut = a.future
        if fut is not None:
            try:
                fut.result()
            except BaseException:      # the collector records it
                pass
    while any(a.state == "sent" for a in sent):
        time.sleep(0.001)              # the last callbacks still running
    return [a for a in sent if a.state != "withdrawn"]


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
    for m in store.models():
        backend.note_trained(m)          # the LRU holds the capital
    return g, leaf_of, svc, backend, tracer


def rate_to_last(answers: List[Answer], t0: float, deadline: float):
    """(answers by the last answer inside the window, its time after t0)."""
    times = sorted(a.t_answer for a in answers
                   if a.error is None and a.t_answer <= deadline)
    return len(times), (times[-1] - t0) if times else 0.0


def run(ctx: Ctx) -> Outcome:
    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    lda_cfg = cfg["lda"]
    k, v = lda_cfg["n_topics"], lda_cfg["vocab_size"]
    g, leaf_of, svc, backend, tracer = build(ctx)
    try:
        warm = settle(open_loop(svc, ctx, "warmup", Collector(ctx, g, leaf_of),
                                count=wl["warmup_queries"]), False)
        bad = [a.error for a in warm if a.error is not None]
        if bad:
            raise RuntimeError(f"warm-up query failed: {bad[0]!r}")
        setup_s = time.perf_counter() - ctx.t_start
        ctx.log(f"set-up {setup_s:.2f}s; window of {ctx.seconds}s")

        reset_peak(dev)
        before = svc.report()
        dw = DeviceWindow(dev, ctx.trace)
        dw.start()
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        collector = Collector(ctx, g, leaf_of)
        sent = open_loop(svc, ctx, "window", collector, until=deadline)
        ran = settle(sent, True)
        device_trace = dw.stop()
        memory_peak = peak_bytes(dev)
        after = svc.report()
    finally:
        svc.close()

    ok = [a for a in ran if a.error is None]
    n_in, span_s = rate_to_last(ran, t0, deadline)
    qps = n_in / span_s if span_s > 0 else 0.0
    failed = len(ran) - len(ok)
    late = max((a.t_sent - a.t_due for a in sent), default=0.0)
    ctx.log(f"{len(sent)} sent ({len(sent) - len(ran)} withdrawn after the "
            f"window, sender at most {late * 1e3:.2f} ms late); {n_in} "
            f"answered in {span_s:.3f}s ({qps:.3f}/s), {failed} failed")
    for a in ran:
        if a.error is not None:
            ctx.log(f"failed: [{a.lo}, {a.hi}): {a.error!r}")

    trace = None
    if ctx.trace:
        spans = [s for s in tracer.spans() if s.t0 >= t0]
        gibbs = []
        for s in spans:
            if s.name == "train":
                t_0, t_1 = g.tokens_in(s.attrs["lo"], s.attrs["hi"])
                d_0, d_1 = g.docs_in(s.attrs["lo"], s.attrs["hi"])
                one = costs.gibbs_sweep(t_1 - t_0, d_1 - d_0, k, v)
                gibbs.extend([one] * lda_cfg["gibbs_sweeps"])
        trace = TraceCtx(
            device=device_trace, spans=spans,
            latencies=[a.t_answer - a.t_due for a in ok],
            work={"merge": [costs.merge(a.n_merged, k, v) for a in ok],
                  "gibbs": gibbs},
            counters={"groups": after.groups - before.groups,
                      "width_sum": after.width_sum - before.width_sum},
            answered=len(ok))

    sample = _sample(ctx, ok, collector.longest)
    attempted = len(ran)
    del svc, backend, sent, ran, ok, warm
    release(dev)

    t_ref = time.perf_counter()
    prior = torch.zeros((k, v), dtype=torch.float64, device=dev)
    for lo, hi in leaf_of.values():
        prior += checks.counts(g, *g.tokens_in(lo, hi), dev)
    gen = torch.Generator(device=dev).manual_seed(
        sub_seed(ctx.seed, "reference"))
    numbers = checks.gs_answers(g, sample, lda_cfg, prior, gen, dev)
    ctx.log(f"reference over {len(sample)} answers: "
            f"{time.perf_counter() - t_ref:.2f}s")
    return Outcome(setup_s=setup_s, e2e={"queries_per_s": qps},
                   attempted=attempted, failed=failed,
                   checks=judge(numbers, wl["limits"]),
                   memory_peak_bytes=memory_peak, trace=trace)


def _sample(ctx: Ctx, answered: List[Answer],
            longest: Optional[Answer]) -> List[dict]:
    """``check_answers`` of the window's answers whose β was kept, drawn
    from the seed, and the answer whose gaps hold the most tokens, as the
    reference reads them."""
    kept = [a for a in answered if a.beta is not None and a is not longest]
    rng = np.random.default_rng(sub_seed(ctx.seed, "check"))
    n = min(ctx.workload["check_answers"], len(kept))
    pick = [kept[i] for i in sorted(rng.choice(len(kept), size=n,
                                               replace=False))]
    if longest is not None and longest.state == "answered":
        pick.append(longest)
    return [{"sigma": (a.lo, a.hi), "beta": a.beta, "fetched": a.fetched,
             "gaps": a.gaps} for a in pick]
