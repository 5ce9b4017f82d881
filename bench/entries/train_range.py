"""Entry ``train_range``: capital building, one job in a closed loop.

``MLegoSession(corpus, cfg, backend=DeviceBackend, kind=...)
.train_range(lo, hi)`` over consecutive windows of ``window_units``,
from a window picked by the seed, each stored as it is trained.  The
first ``warmup_windows`` go through the same session in set-up.  The
window stops starting new windows once ``--seconds`` have passed; the
rate is the tokens of every window trained in it over the time from
its start to the end of its last window.

Workload keys: ``window_units``, ``warmup_windows``, ``check_windows``
(how many trained windows, drawn from the seed, the reference fits
again), ``limits``.
"""
from __future__ import annotations

import time

import numpy as np

from bench.costs import kernels as costs
from bench.devtrace.window import DeviceWindow
from bench.entries.common import (Ctx, Outcome, TraceCtx, generate, judge,
                                  lda_config, peak_bytes, program_corpus,
                                  release, reset_peak, sync)
from bench.reference import checks, lda as ref
from bench.traffic.queries import capital_windows, sub_seed


def run(ctx: Ctx) -> Outcome:
    from repro_torch.api.backend import DeviceBackend
    from repro_torch.api.session import MLegoSession
    from repro_torch.obs.trace import Tracer

    cfg, wl, dev = ctx.config, ctx.workload, ctx.device
    g = generate(ctx)
    ctx.log(f"corpus: {g.n_docs} docs, {g.n_tokens} tokens")
    tracer = Tracer(capacity=1 << 20, enabled=ctx.trace)
    backend = DeviceBackend(capacity=cfg["backend"]["capacity"], device=dev,
                            profile=ctx.trace)
    prog_seed = sub_seed(ctx.seed, "program")
    sess = MLegoSession(program_corpus(g), lda_config(ctx), backend=backend,
                        kind=cfg["kind"], cost="analytic", seed=prog_seed,
                        device=dev, tracer=tracer)
    windows = capital_windows(wl["window_units"], cfg["corpus"]["attr_max"],
                              ctx.seed)
    trained = []        # (training call, (lo, hi), model, in the window)

    def train(in_window: bool) -> None:
        lo, hi = next(windows)
        with tracer.span("bench.window", "bench", attrs={"lo": lo, "hi": hi}):
            m = sess.train_range(lo, hi)
        if m is not None:
            trained.append((len(trained), (lo, hi), m, in_window))

    for _ in range(wl["warmup_windows"]):
        train(False)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t_start
    ctx.log(f"set-up {setup_s:.2f}s; window of {ctx.seconds}s")

    reset_peak(dev)
    dw = DeviceWindow(dev, ctx.trace)
    dw.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        train(True)
    t1 = time.perf_counter()
    device_trace = dw.stop()
    memory_peak = peak_bytes(dev)

    done = [t for t in trained if t[3]]
    n_tok = sum(t[2].n_tokens for t in done)
    rate = n_tok / (t1 - t0)
    ctx.log(f"{len(done)} windows, {n_tok} tokens in {t1 - t0:.3f}s: "
            f"{rate:.1f} tokens/s")

    trace = None
    k, v = cfg["lda"]["n_topics"], cfg["lda"]["vocab_size"]
    if ctx.trace:
        work = []
        for _, (lo, hi), _, _ in done:
            t_0, t_1 = g.tokens_in(lo, hi)
            _, _, cnt, n_docs = ref.doc_term(g.tokens[t_0:t_1],
                                             g.doc_ids[t_0:t_1], v, dev)
            one = costs.vb_estep(n_docs, k, v, int(cnt.numel()),
                                 cfg["lda"]["e_step_iters"])
            work.extend([one] * cfg["lda"]["max_iters"])
        trace = TraceCtx(device=device_trace,
                         spans=[s for s in tracer.spans() if s.t0 >= t0],
                         work={"vb_estep": work}, answered=len(done))

    rng = np.random.default_rng(sub_seed(ctx.seed, "check"))
    pick = rng.choice(len(done), size=min(wl["check_windows"], len(done)),
                      replace=False)
    sample = [(rg, m.theta["lam"], call)
              for call, rg, m, _ in (done[i] for i in sorted(pick))]
    n_windows = len(done)
    del sess, backend, trained, done
    release(dev)

    t_ref = time.perf_counter()
    numbers = checks.vb_windows(
        g, [(rg, lam, ref.session_lambda0(prog_seed, call, k, v, dev))
            for rg, lam, call in sample], cfg["lda"], dev)
    ctx.log(f"reference over {len(sample)} windows: "
            f"{time.perf_counter() - t_ref:.2f}s")
    return Outcome(setup_s=setup_s, e2e={"train_tokens_per_s": rate},
                   attempted=n_windows, failed=0,
                   checks=judge(numbers, wl["limits"]),
                   memory_peak_bytes=memory_peak, trace=trace)
