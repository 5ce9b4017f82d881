#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MLego once on one GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card.  It
imports only ``repro_torch`` (from ``src/``), never JAX or ``repro``.
Phases, each of which fails the run if anything in it fails:

1. build  — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (first use builds them; the build time is printed);
2. kernels — call every kernel of the paths on the card at the main
   paths' shapes and at edge shapes, hold each against its plain PyTorch
   version at the stated tolerance, and time the kernel, the plain
   version and (where one exists) a single PyTorch call computing the
   same function, beside the least time the card could take.  The merge
   is held in its (n, K, V) form and in its parts form (n separate
   tensors, n = 1, 8 and 129: weights by value, and a pointer table on
   the device above 128 parts), five repeat calls giving the same bits.
   The sparse E-step runs on ``doc_term_csr(x)`` and is held against the
   dense plain version at D = 2,048 and 1,000 (both timed, with the
   conversion timed apart), an edge shape and two shapes whose documents
   overflow a CTA's row budget; five repeat calls give the same bits.  Both
   attention kernels are held and timed in bf16 (tensor cores: the SASS
   of every bf16 instance must contain HMMA or HGMMA, and five repeat
   calls must give the same bits) and in f32 (CUDA cores).  The Gibbs
   samplers' plain versions add the conditional in the kernels' warp-scan
   order, so every draw and count must be equal, and the counts must be
   conserved: the blocked sweep (one warp a document) on a 1,000-document
   window, on the same window with each block's documents interleaved and
   on an edge shape; the exact scan on a 1,000-document gap, on a stream of
   repeated words whose documents recur out of order and on an edge shape;
   five repeat calls give the same bits.  Each sweep's longest chain and
   its ns per chain step are printed, and one whole ``cgs_fit_blocked`` and
   one ``cgs_fit`` of a 1,000-document window are timed beside the sum of
   their sweep kernels' times.  The sLSTM scan is held on each of its
   three routes (``scan_plan``: a decode step, a thread block cluster
   per head, the cooperative kernel for an f32 R of 512), each timed at
   the served shape and giving the same bits on five calls; the route,
   cluster size and max active clusters of each case and each route's
   latency floor (its step with almost no work) are printed;
3. main path — at the default ``LDAConfig`` widths (K = 100, V = 8192)
   build 32 window models with ``train_range`` on the ``"device"``
   backend, answer a covered ``submit`` (merge only), a ``submit`` with
   half-window edges (gaps trained by the E-step kernel) and a
   ``submit_many`` of four specs (one ragged launch); every kernel's
   launch count must grow, no report may fall back, β must be finite
   with rows summing to 1, and the covered β must match the ``"host"``
   backend over the same store;
4. routes — a gap query on the ``"host"`` backend and a gap replayed on
   it after an injected device loss must both launch the E-step kernel;
5. the ``"gs"`` path — the same corpus and widths with collapsed Gibbs
   and the DSGS prior: 16 windows by ``train_range`` and the gaps of a
   ``submit`` with half-window edges train with the blocked sweep kernel,
   a covered ``submit`` and a ``submit_many`` merge, and a ``"host"`` gap
   query and a replay on ``"host"`` after an injected device loss train
   with the exact-scan kernel; the same checks as phase 3, and the
   covered β must fit the corpus better than uniform topics;
6. serve — the LM serving path at qwen3-1.7b's full width (28 layers,
   d_model 2,048, 16 query and 8 KV heads of 128, vocab 152,064 padded,
   bf16, random weights from ``torch.Generator`` seed 0): one batch of 4
   prompts of 2,048 tokens (``make_batch``) through
   ``repro_torch.launch.serve.generate`` with a 2,112-position cache and
   64 greedy decode steps; exactly 28 flash launches for the prefill and
   28 decode launches per step, finite logits, tokens in the padded
   vocabulary, and, with the same weights in float32, decode_step after a
   2,048-token prefill must equal a 2,049-token prefill at 2e-3;
7. xlstm — the xLSTM serving path at xlstm-1.3b's full width (48 layers:
   42 mLSTM and 6 sLSTM, d_model 2,048, 4 heads of 512, vocab 50,304
   padded, tied embeddings, bf16, random weights from ``torch.Generator``
   seed 0): the same batch shape through ``generate`` with 64 greedy
   steps; exactly 6 sLSTM kernel launches for the prefill (cluster
   route) and 6 per step (step route), finite logits, tokens in the padded vocabulary, peak memory
   allocated at most 10 GB, and, in float32, decode_step after a
   256-token prefill must equal a 257-token prefill at 2e-3;
8. service — ``MLegoService`` (``backend="device"``, two workers a pool,
   a 5 ms coalescing window up to 16 wide) over [0, 24,000) of phase 3's
   corpus and config: 16 ``"vb"`` and 4 ``"gs"`` windows by
   ``train_range``; four tenants submit 8 specs each from four threads at
   once (covered ranges, half-window edges, ``"gs"`` ranges, and a repeat
   of the first tenant's covered ranges); every answer comes from
   ``"device"`` with finite β whose rows sum to 1, a window fuses (width
   >= 2, a ragged launch), another tenant's repeat of a spec answered
   alone rides the shared plan cache, and a covered β equals a
   ``"host"`` session's over the service's store at 1e-5.  Then
   streaming ingest of [24,000, 32,000) in 4 batches (8 slices of 1,000,
   ``build_errors == 0``, at least one compaction under a byte budget,
   the E-step kernel launched, the range answered with no training), a
   speculator that pre-trains a hot gapped range on the card and is hit,
   a ``profile=True`` session whose covered merge shows its
   ``mlego.merge_topics`` range in a ``torch.profiler`` capture and its
   ``kernel_hbm_bytes`` (row 1's bound bytes), and an injected device
   loss answered by ``"host"`` that trips the device breaker.
   ``close()`` must join every thread within 300 s.

The launch counts reported for a kernel are those of the paths that run
it (phases 3–4 for the ``"vb"`` path, phase 5 for the ``"gs"`` path,
phase 6 for the serve path, phase 7 for the ``"xlstm"`` path, phase 8
for the ``"service"`` path),
each counter set to 0 just before its path and read just after:
``launches_by_path`` holds each path's count and ``launches`` their sum
(the merges run on both paths).  The batched merge is on neither path
(it is the ragged merge's retired parity reference) and reports 0.  The
E-step counts two launches a call (iterations, then sstats); the (V, K)
transpose of eeβ it makes first is a PyTorch copy, timed with the call.

The second-to-last line of output is the kernel table as JSON, the line
before it the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero and
prints no result line.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the card's published peaks (H100 SXM data sheet): HBM bytes/s and
# fp32 (non-tensor-core) flop/s — the denominators of every bound below —
# and the dense bf16 tensor-core rate, the bound of bf16 attention (f32
# attention is bound by the fp32 rate: TF32 would not keep its tolerance)
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12

MERGE_TOL = 1e-5
ESTEP_TOL = 2e-4
SERVE_B, SERVE_PROMPT, SERVE_CACHE, SERVE_STEPS = 4, 2048, 2112, 64
XL_B, XL_S, XL_H, XL_HD = 4, 2048, 4, 512   # the xLSTM path's sLSTM shape
XL_CHECK_PROMPT = 256      # prompt of the xLSTM float32 consistency check
XL_PEAK_GB = 10.0          # peak memory the xLSTM serve path may allocate
CONSISTENCY_TOL = 2e-3
TRAIN_BUDGET_S = 300.0     # seconds the main path may spend in VB training
N_WINDOWS = 32
GS_TRAIN_BUDGET_S = 120.0  # seconds the gs path may spend in train_range
GS_WINDOWS = 16
T_START = time.perf_counter()


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def tensor_core_instructions(lib_path: Path) -> dict:
    """{kernel function: count of HMMA/HGMMA instructions} in the SASS of
    the built library (``cuobjdump -sass``)."""
    import shutil
    from torch.utils.cpp_extension import CUDA_HOME
    tool = shutil.which("cuobjdump") or str(Path(CUDA_HOME or "/usr/local/cuda")
                                            / "bin" / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return counts


def bound_ms(n_bytes: float, n_ops: float, peak_flops: float = PEAK_F32_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def service_phase(corpus, cfg, device, unit: float, card: str) -> dict:
    """Phase 8: the multi-tenant query service on ``device``.

    ``corpus`` spans [0, 32·unit); the service starts over [0, 24·unit)
    and ingests the rest.  Every check that needs no launch counter
    raises here; the counters' deltas are returned (with the counts of
    the whole phase, read after ``close()``) for the caller to hold.
    """
    import contextlib
    import functools
    import threading

    import numpy as np
    import torch

    from repro_torch.api import Interval, MLegoSession, QuerySpec
    from repro_torch.api.backend import make_backend
    from repro_torch.ingest import CompactionPolicy
    from repro_torch.kernels.gibbs_sweep import ops as gibbs_ops
    from repro_torch.kernels.merge_topics import ops as merge_ops
    from repro_torch.kernels.vb_estep import ops as estep_ops
    from repro_torch.serve import OPEN, MLegoService
    from repro_torch.testing.faults import FaultRule, injected

    timeout = 300.0
    k, v = cfg.n_topics, cfg.vocab_size

    def iv(lo, hi):
        return Interval(lo * unit, hi * unit)

    def check(ok, msg):
        if not ok:
            raise AssertionError(f"[service] {msg}")

    def check_beta(r, what):
        check(r.beta.shape == (k, v) and np.isfinite(r.beta).all(),
              f"{what}: beta is not finite ({k}, {v})")
        err = float(np.abs(r.beta.sum(1) - 1.0).max())
        check(err <= 1e-5, f"{what}: beta rows sum to 1 +- {err}")

    class TrainLog:
        """Wraps a device backend's trainers.  Recording, it keeps each
        training's documents, generator seed and result, from whatever
        thread trains; replaying (``recorded`` given), it trains with the
        seed recorded for the same documents, which must have been
        trained exactly once."""

        def __init__(self, backend, recorded=None):
            self.recorded = recorded
            self.runs = {}
            self.lock = threading.Lock()
            self.inner = backend.trainer
            backend.trainer = self.trainer

        @staticmethod
        def key(kind, sub):
            return (kind, sub.n_docs, sub.n_tokens, float(sub.attr[0]),
                    float(sub.attr[-1]))

        def snapshot(self):
            with self.lock:
                return {key: list(runs) for key, runs in self.runs.items()}

        def trainer(self, kind):
            fn = self.inner(kind)

            # wraps: the executor reads the trainer's signature
            @functools.wraps(fn)
            def train(sub, cfg_, gen, **kw):
                key = self.key(kind, sub)
                if self.recorded is not None:
                    runs = self.recorded.get(key, [])
                    check(len(runs) == 1, f"the replay trains {key}, which "
                          f"the service trained {len(runs)} times")
                    gen = torch.Generator(device=gen.device).manual_seed(
                        runs[0][0])
                theta = fn(sub, cfg_, gen, **kw)
                with self.lock:
                    self.runs.setdefault(key, []).append(
                        (gen.initial_seed(), theta))
                return theta
            return train

    counters = ((merge_ops, "merge_topics_launches"),
                (merge_ops, "merge_topics_ragged_launches"),
                (merge_ops, "merge_topics_batch_launches"),
                (estep_ops, "launches"),
                (gibbs_ops, "gibbs_sweep_launches"),
                (gibbs_ops, "cgs_sweep_exact_launches"))
    for mod, name in counters:
        setattr(mod, name, 0)
    grew = {}
    elsewhere = {}

    @contextlib.contextmanager
    def not_the_service(what):
        """Launches of a session that is not the service (a replay, the
        profiled session) go to ``elsewhere[what]`` and back out of the
        service path's counts; no service thread launches meanwhile."""
        before = [getattr(mod, name) for mod, name in counters]
        try:
            yield
        finally:
            seen = elsewhere.setdefault(what, {})
            for (mod, name), b in zip(counters, before):
                if getattr(mod, name) != b:
                    seen[name] = seen.get(name, 0) + getattr(mod, name) - b
                setattr(mod, name, b)

    # 1. the service and its capital
    t0 = time.perf_counter()
    svc = MLegoService(corpus.subset(0.0, 24 * unit), cfg, backend="device",
                       device=device, window_s=0.005, max_width=16,
                       workers_per_pool=2)
    trained = TrainLog(svc.backend)
    for i in range(16):
        m = svc.train_range(i * unit, (i + 1) * unit)
        check(m is not None and m.n_docs > 0, f"vb window {i} is empty")
    for i in range(4):
        m = svc.train_range(i * unit, (i + 1) * unit, kind="gs")
        check(m is not None and m.kind == "gs", f"gs window {i} missing")
    log(f"[service] train_range: 16 vb + 4 gs windows of {unit:g} units in "
        f"{time.perf_counter() - t0:.2f} s, {len(svc.store)} models; on "
        f"{card}")

    # 2. four tenants submitting at once, 8 specs each
    covered = [iv(0, 8), iv(0, 4), iv(4, 8), iv(8, 16), iv(0, 16), iv(2, 6),
               iv(12, 16), iv(0, 1)]
    edged = [iv(8.5, 12.5), iv(0.5, 3.5), iv(1.5, 7.5), iv(10.5, 14.5),
             iv(4.5, 9.5), iv(12.5, 15.5), iv(2.5, 5.5), iv(6.5, 13.5)]
    gs_ranges = [iv(0, 4), iv(0.5, 4.5), iv(0, 2), iv(2, 4), iv(1, 3),
                 iv(0, 1), iv(3, 4), iv(1, 4)]
    plans = {
        "ana": [QuerySpec(sigma=s) for s in covered],
        "bob": [QuerySpec(sigma=s, materialize="volatile") for s in edged],
        "cy": [QuerySpec(sigma=s, kind="gs", materialize="volatile")
               for s in gs_ranges],
        "dan": [QuerySpec(sigma=s) for s in covered],   # repeats ana's
    }
    futures = {t: [] for t in plans}
    latency = {t: [] for t in plans}
    start = threading.Barrier(len(plans))

    def client(tenant):
        start.wait(timeout=timeout)
        for spec in plans[tenant]:
            t_sub = time.perf_counter()
            fut = svc.submit(spec, tenant=tenant)
            fut.add_done_callback(
                lambda _f, t=t_sub, lat=latency[tenant]:
                lat.append(time.perf_counter() - t))
            futures[tenant].append(fut)

    threads = [threading.Thread(target=client, args=(t,), daemon=True)
               for t in plans]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=timeout)
        check(not th.is_alive(), f"client {th.name} did not finish")
    reports = {t: [f.result(timeout=timeout) for f in fs]
               for t, fs in futures.items()}
    t_burst = time.perf_counter() - t0
    rep = svc.report()
    for t, reps in reports.items():
        check(len(reps) == len(plans[t]), f"{t}: answers missing")
        for r in reps:
            check(r.backend == "device" and r.fallback_from is None,
                  f"{t}: answered by {r.backend} (from {r.fallback_from})")
        log(f"[service] tenant {t}: {len(reps)} answers, latency p50 "
            f"{np.percentile(latency[t], 50) * 1e3:.1f} ms, p95 "
            f"{np.percentile(latency[t], 95) * 1e3:.1f} ms (host clock, "
            f"submit to answer), {sum(r.plan_cached for r in reps)} plans "
            f"cached, {sum(r.n_trained_tokens for r in reps)} trained "
            f"tokens; on {card}")
    for r in reports["ana"] + reports["dan"]:
        check(r.n_trained_tokens == 0, "a covered spec trained tokens")
        check_beta(r, "covered")
    for r in reports["bob"] + reports["cy"]:
        check_beta(r, "gapped")
    check(any(r.n_trained_tokens > 0 for r in reports["bob"]),
          "no half-window spec trained a gap")
    check(rep.errors == 0 and rep.queries == 32,
          f"{rep.errors} errors in {rep.queries} answers")
    check(rep.max_coalesce_width >= 2, "no window fused")
    grew["burst_ragged"] = merge_ops.merge_topics_ragged_launches
    log(f"[service] burst: 32 answers in {t_burst:.2f} s; {rep.groups} "
        f"groups, coalesce width mean {rep.mean_coalesce_width:.2f} max "
        f"{rep.max_coalesce_width}; plan cache {rep.plan_cache_hits} hits "
        f"{rep.plan_cache_misses} misses; on {card}")
    # a fused group plans as one batch; a spec that drains alone plans on
    # its own, and another tenant's repeat of it reuses that plan
    alone = [svc.submit(QuerySpec(sigma=covered[0]), tenant=t).result(
        timeout=timeout) for t in ("ana", "dan")]
    check(not alone[0].plan_cached and alone[1].plan_cached,
          "dan's repeat of ana's spec did not ride the shared plan cache")
    host = MLegoSession(svc.corpus, cfg, store=svc.store, backend="host",
                        device=device)
    want = host.submit(QuerySpec(sigma=covered[0]))
    got = reports["ana"][0]
    diff = float(np.abs(want.beta - got.beta).max())
    check(want.model_ids == got.model_ids and np.allclose(
        got.beta, want.beta, rtol=1e-5, atol=1e-5),
        f"service beta differs from a host session's by {diff}")
    log(f"[service] covered beta against a host session over the service's "
        f"store: max abs diff {diff:.3g} (tol 1e-5)")
    # one gapped answer of each kind, trained by the pool's workers beside
    # each other, against the same spec answered on this thread by a
    # device session over the same store, each gap trained with the seed
    # the service trained it with
    replay_backend = make_backend("device", device=device)
    TrainLog(replay_backend, recorded=trained.snapshot())
    replay = MLegoSession(svc.corpus, cfg, store=svc.store,
                          backend=replay_backend, device=device)
    for tenant, tol in (("bob", ESTEP_TOL), ("cy", 0.0)):
        i = next(i for i, r in enumerate(reports[tenant])
                 if r.n_trained_tokens > 0)
        got, spec = reports[tenant][i], plans[tenant][i]
        with not_the_service("replay"):
            want = replay.submit(spec)
        check(want.model_ids == got.model_ids
              and want.n_trained_tokens == got.n_trained_tokens,
              f"{tenant}: the replay planned {want.model_ids}, "
              f"{want.n_trained_tokens} tokens; the service "
              f"{got.model_ids}, {got.n_trained_tokens}")
        diff = float(np.abs(want.beta - got.beta).max())
        check(diff <= tol, f"{tenant}: the gapped answer differs from its "
              f"one-thread replay by {diff} (tol {tol})")
        log(f"[service] {tenant}'s gapped {spec.kind or svc.kind!r} answer "
            f"({got.n_trained_tokens} trained tokens) against its one-thread "
            f"replay with the service's seeds: max abs diff {diff:.3g} "
            f"(tol {tol:g})")

    # 3. streaming ingest of [24, 32)·unit with compaction
    per_model = k * v * 4
    budget = (len(svc.store.models("vb")) + 8 - 4) * per_model
    before = estep_ops.launches
    pipe = svc.attach_ingest(slice_width=unit, start=24 * unit,
                             compaction=CompactionPolicy(max_bytes=budget))
    t0 = time.perf_counter()
    for b in range(4):
        svc.ingest(corpus.subset((24 + 2 * b) * unit, (26 + 2 * b) * unit))
    check(pipe.flush(timeout=timeout), "the ingest builder did not drain")
    pipe.close()
    t_ingest = time.perf_counter() - t0
    grew["ingest_estep"] = estep_ops.launches - before
    ing = pipe.report()
    check(ing.slices_built == 8 and ing.build_errors == 0,
          f"{ing.slices_built} slices built, {ing.build_errors} errors")
    check(ing.compactions >= 1, "the byte budget compacted nothing")
    fresh = svc.submit(QuerySpec(sigma=iv(24, 32)), tenant="ana").result(
        timeout=timeout)
    check(fresh.n_trained_tokens == 0 and fresh.backend == "device",
          f"the ingested range trained {fresh.n_trained_tokens} tokens")
    check_beta(fresh, "ingested")
    # the first slice, built by the builder thread while batches were
    # still appended, against the same fit on this thread with its seed
    lo = 24 * unit
    sub = pipe.corpus.subset(lo, lo + unit)
    runs = trained.snapshot().get(TrainLog.key("vb", sub), [])
    check(len(runs) == 1, f"slice [{lo:g}, {lo + unit:g}) was trained "
          f"{len(runs)} times")
    seed, built = runs[0]
    with not_the_service("replay"):
        again = svc.backend.trainer("vb")(
            sub, cfg, torch.Generator(device=device).manual_seed(seed))
    stored = [m for m in svc.store.models("vb")
              if (m.o.lo, m.o.hi) == (lo, lo + unit)]
    diff = float(np.abs(again["lam"] - built["lam"]).max())
    scale = float(np.abs(built["lam"]).max())
    check(diff <= ESTEP_TOL * (1.0 + scale),
          f"slice theta differs from its one-thread refit by {diff}")
    check(all(np.array_equal(m.theta["lam"], built["lam"]) for m in stored),
          "the stored slice is not the one the builder trained")
    log(f"[service] slice [{lo:g}, {lo + unit:g}) ({sub.n_docs} docs) against "
        f"its one-thread refit with the builder's seed: max abs diff "
        f"{diff:.3g} of max |lam| {scale:.3g} (tol {ESTEP_TOL:g}·(1 + max "
        f"|lam|)); {len(stored)} stored copy, the same bits")
    log(f"[service] ingest: {ing.batches} batches, {ing.docs} docs, "
        f"{ing.slices_built} slices in {t_ingest:.2f} s (append to last "
        f"slice built), freshness lag mean {ing.freshness_lag_s_mean:.3f} s "
        f"max {ing.freshness_lag_s_max:.3f} s, {ing.compactions} "
        f"compactions, {ing.evictions} evictions under a "
        f"{budget / 1e6:.1f} MB budget; on {card}")

    # 4. speculation: a hot gapped range pre-trained, then a hit
    hot = QuerySpec(sigma=iv(15.5, 16.5), alpha=0.5, materialize="volatile")
    first = [svc.submit(hot, tenant="eve").result(timeout=timeout)
             for _ in range(2)]
    check(all(r.n_trained_tokens > 0 for r in first),
          "the hot range has no gap to speculate on")
    spec_tr = svc.attach_speculator(min_count=2, window_s=60.0, margin=0.0,
                                    start=False)
    before = estep_ops.launches
    t0 = time.perf_counter()
    n_spec = spec_tr.scan_once()
    t_spec = time.perf_counter() - t0
    grew["speculation_estep"] = estep_ops.launches - before
    check(n_spec >= 1, "the speculator trained no gap")
    again = svc.submit(hot, tenant="eve").result(timeout=timeout)
    sp = svc.report().speculation
    check(sp.hits >= 1, "the hot range's next answer missed the "
          "speculated capital")
    log(f"[service] speculation: {sp.trained} gaps, {sp.trained_tokens} "
        f"tokens pre-trained in {t_spec:.2f} s; the next answer trained "
        f"{again.n_trained_tokens} tokens (before: "
        f"{first[0].n_trained_tokens}), {sp.hits} hits; on {card}")

    # 5. profiling: the merge's range in a torch.profiler capture, its
    # kernel.launch span carrying the bound's bytes
    psess = MLegoSession(svc.corpus, cfg, store=svc.store, backend="device",
                         device=device, profile=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with not_the_service("profile"), \
            torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        prep = psess.submit(QuerySpec(sigma=covered[0], alpha=1.0))
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    names = {e.name for e in prof.events()}
    check("mlego.merge_topics" in names,
          "no mlego.merge_topics range in the profile")
    n = len(prep.model_ids)
    spans = [s for s in psess.tracer.spans(trace_id=prep.trace,
                                           name="kernel.launch")
             if s.attrs.get("op") == "merge_topics"]
    want_bytes = 4.0 * (n * k * v + n + k * v)
    check(spans and spans[0].attrs.get("kernel_hbm_bytes") == want_bytes,
          f"kernel.launch span bytes {spans and spans[0].attrs} != "
          f"{want_bytes}")
    # the capture's device activity (kernels and copies; the mlego.*
    # ranges projected onto the device timeline are spans, not work)
    # against the query's wall: a new session's first merge uploads its
    # parts
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ranges = [e for e in on_card if e.name.startswith("mlego.")
              or getattr(e, "is_user_annotation", False)]
    work = [e for e in on_card if all(e is not r for r in ranges)]

    def span_us(events, word=""):
        return sum(e.time_range.elapsed_us() for e in events
                   if word in e.name)
    busy_us = span_us(work)
    cuda = int(torch.device(device).type == "cuda")
    check(elsewhere["profile"] == ({"merge_topics_launches": 1} if cuda
                                   else {}),
          f"the profiled submit launched {elsewhere['profile']}")
    log(f"[service] profile: mlego.merge_topics range found; kernel.launch "
        f"span kernel_hbm_bytes {want_bytes:.0f} for n = {n} parts, "
        f"kernel_flops {spans[0].attrs['kernel_flops']:.0f}; the profiled "
        f"submit {t_prof * 1e3:.2f} ms wall, device busy {busy_us:.1f} us "
        f"in {len(work)} kernels and copies (idle share "
        f"{1.0 - busy_us * 1e-6 / t_prof:.3f}): copies "
        f"{span_us(work, 'Memcpy'):.1f} us, merge kernel "
        f"{span_us(work, 'merge'):.1f} us; the mlego.* ranges span "
        f"{span_us(ranges):.1f} us of the device timeline; on {card}")

    # 6. device loss: the answer comes from "host", the breaker trips
    with injected(FaultRule("backend.merge.device", kind="device_lost",
                            max_failures=1)):
        lost = svc.submit(QuerySpec(sigma=covered[0]), tenant="ana").result(
            timeout=timeout)
    check((lost.backend, lost.fallback_from) == ("host", "device"),
          f"device loss answered by {lost.backend} (from "
          f"{lost.fallback_from})")
    check_beta(lost, "fallback")
    br = svc.report().breaker.get("device")
    check(br is not None and br.state == OPEN and br.opens >= 1,
          f"the device breaker did not trip: {br}")
    log(f"[service] device loss: answered by host (fallback from device), "
        f"device breaker {br.state} after {br.opens} open; covered answer "
        f"{lost.total_s * 1e3:.1f} ms on {card}")

    # 7. close joins every thread
    final = svc.report()
    closer = threading.Thread(target=svc.close, daemon=True)
    closer.start()
    closer.join(timeout=timeout)
    alive = [t.name for p in svc._pools_snapshot() for t in p.threads
             if t.is_alive()]
    check(not closer.is_alive() and not alive,
          f"close() left threads running: {alive}")
    launches = {"merge_topics": merge_ops.merge_topics_launches,
                "merge_topics_ragged": merge_ops.merge_topics_ragged_launches,
                "vb_estep": estep_ops.launches,
                "gibbs_sweep": gibbs_ops.gibbs_sweep_launches}
    log(f"[service] kernel launches on the service path: {launches}; "
        f"exact scan {gibbs_ops.cgs_sweep_exact_launches}, batched merge "
        f"{merge_ops.merge_topics_batch_launches}; step deltas {grew}; "
        f"left out, launched by the replays and the profiled session: "
        f"{elsewhere}")
    return dict(launches=launches, grew=grew,
                queries=final.queries, groups=final.groups,
                mean_width=final.mean_coalesce_width,
                max_width=final.max_coalesce_width)


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "check needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.api import Interval, MLegoSession, QuerySpec
    from repro_torch.configs.lda_default import LDAConfig
    from repro_torch.core.lda import log_predictive_probability
    from repro_torch.data.corpus import doc_term_matrix, make_corpus
    from repro_torch.kernels import common
    from repro_torch.core.gibbs import (
        blocked_layout, cgs_fit, cgs_fit_blocked)
    from repro_torch.kernels.gibbs_sweep import ops as gibbs_ops
    from repro_torch.kernels.gibbs_sweep.ref import (
        cgs_sweep_exact_ref, gibbs_sweep_ref)
    from repro_torch.kernels.merge_topics import ops as merge_ops
    from repro_torch.kernels.merge_topics.ref import (
        merge_topics_batched_ref, merge_topics_ref, merge_topics_segments_ref)
    from repro_torch.kernels.vb_estep import ops as estep_ops
    from repro_torch.kernels.vb_estep.ref import (
        vb_estep_csr_ref, vb_estep_ref)
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.slstm_scan import ops as slstm_ops
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref, zero_state

    card = card_line()
    dev = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    common.load_library()
    log(f"[build] {common.library_path().name} ready in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in common.build_log().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("[build]", line.strip())

    # -- 2. kernels against their plain versions ---------------------------
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    # stream memory for ~50 ms before the first timing: the card idled
    # through the build, and the first kernel timed on its cold clocks
    # read about twice its time
    for _ in range(600):
        flush.zero_()
    torch.cuda.synchronize()

    def time_ms(fn, reps: int, read_flush: bool = False) -> float:
        """Mean device time of one call, L2 flushed before each (by
        writing 256 MB).  All calls are queued behind a sleep, so the
        events bracket the kernels and not the host's launch overhead.
        ``read_flush`` reads the 256 MB instead, leaving no dirty lines
        in L2 (a diagnostic: every row's time is the writing flush's)."""
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda._sleep(20_000_000)
        for a, b in ev:
            if read_flush:
                flush.sum()
            else:
                flush.zero_()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in ev) / reps

    def close(got, want, tol, rtol=None) -> float:
        """Max abs error of ``got``; raises unless every element is within
        tol + rtol·|want| (rtol = tol unless given)."""
        rtol = tol if rtol is None else rtol
        err = (got - want).abs()
        bad = err > tol + rtol * want.abs()
        if bool(bad.any()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(
                f"kernel disagrees with its plain version: max abs err "
                f"{float(err.max()):.3g}, {int(bad.sum())} elements over "
                f"{tol} + {rtol}·|want|")
        return float(err.max())

    rng = np.random.default_rng(0)
    cfg0 = LDAConfig()
    report = {}

    # merge_topics: the (n, K, V) form and the parts form (n separate
    # tensors through the kernel's pointer table: by value up to 128, a
    # device table above), each held at 1e-5 and repeated bit for bit
    errs = []
    for n, k, v in [(8, 100, 8192), (1, 6, 150)]:
        st = torch.tensor(rng.gamma(1.0, 1.0, (n, k, v)), dtype=torch.float32,
                          device=dev)
        w = torch.tensor(rng.uniform(0.2, 2.0, n), dtype=torch.float32,
                         device=dev)
        eta = 0.01
        got = merge_ops.merge_topics(st, w, bias=eta, base=eta)
        errs.append(close(got, merge_topics_ref(st, w, eta, eta), MERGE_TOL))
        log(f"[kernels] merge_topics n={n} K={k} V={v}: max abs err "
            f"{errs[-1]:.3g} (tol {MERGE_TOL})")
        if (n, k, v) == (8, 100, 8192):
            s2 = st.view(n, -1).t()
            c = torch.tensor([eta * (1.0 - float(w.sum()))], device=dev)
            ms = time_ms(lambda: merge_ops.merge_topics(st, w, eta, eta), 20)
            plain = time_ms(lambda: merge_topics_ref(st, w, eta, eta), 20)
            lib = time_ms(lambda: torch.addmv(c, s2, w), 20)
            parts8 = list(st.unbind(0))
            ms_parts = time_ms(lambda: merge_ops.merge_topics_parts(
                parts8, [1.0] * n, eta, eta), 20)
            # the kernel the single merge used to run (the batched entry
            # point at b = 1), and both after a reading flush
            ms_b1 = time_ms(lambda: merge_ops.merge_topics_batch(
                st[None], w[None], eta, eta), 20)
            ms_read = time_ms(lambda: merge_ops.merge_topics(
                st, w, eta, eta), 20, read_flush=True)
            ms_b1_read = time_ms(lambda: merge_ops.merge_topics_batch(
                st[None], w[None], eta, eta), 20, read_flush=True)
            b_ms, b_by = bound_ms(4 * (n * k * v + n + k * v), 3 * n * k * v)
            log(f"[kernels] merge_topics n=8: {ms:.4f} ms "
                f"({4 * (n + 1) * k * v / (ms * 1e-3) / 1e12:.2f} TB/s), "
                f"addmv {lib:.4f} ms, parts form with unit weights by value "
                f"{ms_parts:.4f} ms, the batched kernel at b = 1 "
                f"{ms_b1:.4f} ms; after a reading flush {ms_read:.4f} ms "
                f"({4 * (n + 1) * k * v / (ms_read * 1e-3) / 1e12:.2f} "
                f"TB/s), b = 1 {ms_b1_read:.4f} ms; bound {b_ms:.4f} ms "
                f"({b_by})")
    gen_m = torch.Generator(device=dev).manual_seed(0)
    for n in (1, 8, 129):
        k, v = 100, 8192
        parts = [torch.rand((k, v), generator=gen_m, device=dev) * 2.0
                 for _ in range(n)]
        w_host = [float(x) for x in rng.uniform(0.2, 2.0, n)]
        got = merge_ops.merge_topics_parts(parts, w_host, 0.01, 0.01)
        want = merge_topics_ref(torch.stack(parts),
                                torch.tensor(w_host, device=dev), 0.01, 0.01)
        errs.append(close(got, want, MERGE_TOL))
        for _ in range(5):
            if not torch.equal(merge_ops.merge_topics_parts(
                    parts, w_host, 0.01, 0.01), got):
                raise AssertionError("merge_topics_parts gives other bits "
                                     "on a repeat call")
        log(f"[kernels] merge_topics_parts n={n} K={k} V={v} (weights by "
            f"value{', pointer table on the device' if n > merge_ops.MAX_PARAM_PARTS else ''}): "
            f"max abs err {errs[-1]:.3g} (tol {MERGE_TOL}); same bits over 5 "
            f"calls")
        del parts, want
    report["merge_topics"] = dict(
        name="merge_topics", route="cuda",
        source="src/repro_torch/kernels/csrc/merge_topics.cu",
        replaces="src/repro/kernels/merge_topics/merge_topics.py:37",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib, ms_parts_unit_weights=ms_parts,
        ms_batched_b1=ms_b1, ms_after_reading_flush=ms_read,
        ms_batched_b1_after_reading_flush=ms_b1_read)

    # merge_topics_ragged
    counts = [1, 3, 8, 2]
    k, v = 100, 8192
    r = sum(counts)
    st = torch.tensor(rng.gamma(1.0, 1.0, (r, k, v)), dtype=torch.float32,
                      device=dev)
    w = torch.tensor(rng.uniform(0.2, 2.0, r), dtype=torch.float32,
                     device=dev)
    eta = 0.01
    got = merge_ops.merge_topics_segments(st, w, counts, eta, eta)
    err = close(got, merge_topics_segments_ref(st, w, counts, eta, eta),
                MERGE_TOL)
    log(f"[kernels] merge_topics_ragged counts={counts} K={k} V={v}: max abs "
        f"err {err:.3g} (tol {MERGE_TOL})")
    seg = np.repeat(np.arange(len(counts)), counts)
    a_np = np.zeros((len(counts), r), np.float32)
    a_np[seg, np.arange(r)] = w.cpu().numpy()
    a_mat = torch.tensor(a_np, device=dev)
    c = (eta - eta * a_mat.sum(1, keepdim=True)).contiguous()
    s2 = st.view(r, -1)
    ms = time_ms(lambda: merge_ops.merge_topics_segments(st, w, counts, eta,
                                                         eta), 20)
    plain = time_ms(lambda: merge_topics_segments_ref(st, w, counts, eta,
                                                      eta), 20)
    lib = time_ms(lambda: torch.addmm(c, a_mat, s2), 20)
    b_ms, b_by = bound_ms(4 * (r * k * v + r + len(counts) + 1
                               + len(counts) * k * v), 3 * r * k * v)
    report["merge_topics_ragged"] = dict(
        name="merge_topics_ragged", route="cuda",
        source="src/repro_torch/kernels/csrc/merge_topics.cu",
        replaces="src/repro/kernels/merge_topics/merge_topics.py:112",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib)

    # vb_estep: the CSR kernel on doc_term_csr(x) of real doc-term blocks
    # at the main path's widths, held against the dense plain version;
    # then the edge shape, and shapes whose documents overflow the row
    # budget of a CTA (their rows stream in chunks every iteration)
    errs = []
    t_estep_s = None
    estep = {}

    def estep_case(x, eeb, iters, label):
        d, k = x.shape[0], eeb.shape[0]
        g0 = torch.ones((d, k), dtype=torch.float32, device=dev)
        csr = estep_ops.doc_term_csr(x)
        g1, s1 = estep_ops.vb_estep_csr(csr, eeb, g0, 0.5, iters)
        g2, s2 = vb_estep_ref(x, eeb, g0, 0.5, iters)
        errs.append(max(close(g1, g2, ESTEP_TOL), close(s1, s2, ESTEP_TOL)))
        rows, _ = estep_ops.estep_plan(k, csr.max_row)
        log(f"[kernels] vb_estep {label} D={d} K={k} V={x.shape[1]} "
            f"n_iters={iters}: max abs err {errs[-1]:.3g} (tol {ESTEP_TOL}); "
            f"nnz {csr.nnz}, longest document {csr.max_row} nonzeros, "
            f"row budget {rows}"
            + (" (longer documents stream in chunks)"
               if rows < csr.max_row else ""))
        return csr, g0, g1, s1, rows

    def corpus_block(d, k, v, mean_len, seed):
        corpus_d, beta_true = make_corpus(d, v, k, mean_doc_len=mean_len,
                                          seed=seed)
        x = torch.tensor(doc_term_matrix(corpus_d), device=dev)
        eeb = torch.tensor(beta_true + 1e-4, dtype=torch.float32, device=dev)
        return x, (eeb / eeb.sum(1, keepdim=True)).contiguous()

    for d, k, v, iters in [(2048, 100, 8192, 20), (1000, 100, 8192, 20),
                           (135, 6, 150, 20)]:
        x, eeb = corpus_block(d, k, v, 60, 1)
        csr, g0, g1, s1, _ = estep_case(x, eeb, iters, "corpus")
        if d == 2048:
            for _ in range(5):
                g3, s3 = estep_ops.vb_estep_csr(csr, eeb, g0, 0.5, iters)
                if not (torch.equal(g3, g1) and torch.equal(s3, s1)):
                    raise AssertionError("vb_estep gives other bits on a "
                                         "repeat call")
            log("[kernels] vb_estep D=2048: same bits over 5 calls")
        if k != 100:
            continue
        nnz = csr.nnz
        ms = time_ms(lambda: estep_ops.vb_estep_csr(csr, eeb, g0, 0.5,
                                                    iters), 10)
        conv = time_ms(lambda: estep_ops.doc_term_csr(x), 5)
        plain = time_ms(lambda: vb_estep_csr_ref(csr, eeb, g0, 0.5, iters),
                        3)
        dense_plain = time_ms(lambda: vb_estep_ref(x, eeb, g0, 0.5, iters),
                              3)
        # bytes: the CSR (indptr, indices, values, rows, col_ptr, perm),
        # eeb and gamma0 read once; gamma and sstats written once.
        # operations this x needs: phinorm and the gamma product at the
        # nonzeros (4·K flops each, plus the division), the digamma/exp
        # update of every gamma entry (~62 ops), the final multiply by eeb
        n_bytes = 4 * (4 * nnz + d + 1 + v + 1 + k * v + 2 * d * k + k * v)
        n_ops = (iters + 1) * (4 * k * nnz + nnz + 62 * d * k) + k * v
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        estep[d] = dict(ms=ms, plain_ms=plain, dense_plain_ms=dense_plain,
                        conversion_ms=conv, nnz=nnz, bound_ms=b_ms,
                        bound_by=b_by)
        log(f"[kernels] vb_estep D={d}: {ms:.4f} ms, "
            f"{n_ops / (ms * 1e-3) / 1e12:.3f} TFLOP/s at the nonzeros "
            f"({nnz} of {d * v}, {100.0 * nnz / (d * v):.2f}%); bound "
            f"{b_ms:.4f} ms ({b_by}); conversion (doc_term_csr, once per "
            f"fit) {conv:.4f} ms; plain CSR {plain:.3f} ms, plain dense "
            f"{dense_plain:.3f} ms")
    t_estep_s = estep[2048]["ms"] * 1e-3
    # documents longer than the row budget: K = 256 at 40% nonzeros, and
    # a corpus of ~1,000-token documents at the main path's widths
    x = torch.tensor(rng.poisson(0.5, (17, 300)), dtype=torch.float32,
                     device=dev)
    eeb = torch.tensor(rng.gamma(1.0, 1.0, (256, 300)), dtype=torch.float32,
                       device=dev)
    eeb = (eeb / eeb.sum(1, keepdim=True)).contiguous()
    csr, *_, rows = estep_case(x, eeb, 8, "poisson")
    overflow = [rows < csr.max_row]
    x, eeb = corpus_block(64, 100, 8192, 1000, 4)
    csr, *_, rows = estep_case(x, eeb, 20, "long documents")
    overflow.append(rows < csr.max_row)
    if not all(overflow):
        raise AssertionError("an overflow shape fit the row budget: the "
                             "chunked path was not run")
    report["vb_estep"] = dict(
        name="vb_estep", route="cuda",
        source="src/repro_torch/kernels/csrc/vb_estep.cu",
        replaces="src/repro/kernels/vb_estep/vb_estep.py:76",
        max_abs_err=max(errs), library_ms=None,
        **{key: estep[2048][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "dense_plain_ms",
            "conversion_ms", "nnz")},
        at_d1000={key: estep[1000][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "conversion_ms",
            "nnz")})
    del x, eeb, csr
    # merge_topics_batch (b merges of n rows in one launch)
    errs = []
    for b, n, k, v in [(4, 8, 100, 8192), (3, 2, 6, 150)]:
        st = torch.tensor(rng.gamma(1.0, 1.0, (b, n, k, v)),
                          dtype=torch.float32, device=dev)
        w = torch.tensor(rng.uniform(0.2, 2.0, (b, n)), dtype=torch.float32,
                         device=dev)
        for bias in (0.0, 0.01):               # the gs and the vb merge
            got = merge_ops.merge_topics_batch(st, w, bias, bias)
            errs.append(close(got, merge_topics_batched_ref(st, w, bias, bias),
                              MERGE_TOL))
        log(f"[kernels] merge_topics_batch b={b} n={n} K={k} V={v}: max abs "
            f"err {max(errs[-2:]):.3g} (tol {MERGE_TOL})")
        if (b, n) == (4, 8):
            # bias = base = 0 (the gs merge): one einsum is the same function
            ms = time_ms(lambda: merge_ops.merge_topics_batch(st, w), 20)
            plain = time_ms(lambda: merge_topics_batched_ref(st, w), 20)
            lib = time_ms(lambda: torch.einsum("bn,bnkv->bkv", w, st), 20)
            b_ms, b_by = bound_ms(4 * (b * n * k * v + b * n + b * k * v),
                                  2 * b * n * k * v)
    report["merge_topics_batch"] = dict(
        name="merge_topics_batch", route="cuda",
        source="src/repro_torch/kernels/csrc/merge_topics.cu",
        replaces="src/repro/kernels/merge_topics/merge_topics.py:66",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib)

    # gibbs_sweep: one blocked sweep of a 1,000-document window at the
    # main path's widths (one warp a document: the longest document is the
    # chain), the same window with each block's slots shuffled (documents
    # interleaved), then an edge shape (K = 6, a ragged last block)
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = []
    t_sweep_s = None

    def same_bits_5(fn, args, what):
        first = fn(*args)
        for _ in range(4):
            if not all(torch.equal(a, b) for a, b in zip(fn(*args), first)):
                raise AssertionError(f"{what}: 5 calls gave different bits")

    for label, n_docs, k, v, mean_len, bd in [
            ("main", 1000, 100, 8192, 60, 64),
            ("interleaved", 1000, 100, 8192, 60, 64),
            ("edge", 90, 6, 150, 12, 16)]:
        win, _ = make_corpus(n_docs, v, k, mean_doc_len=mean_len, seed=2)
        words, ldoc, mask = (torch.tensor(a, device=dev) for a in
                             blocked_layout(win.tokens, win.doc_ids,
                                            win.n_docs, bd))
        nb, t = words.shape
        if label == "interleaved":
            # shuffle each block's real slots: a document's tokens scatter
            # over its block (the kernel takes any ldoc order)
            for i in range(nb):
                n_real = int(mask[i].sum())
                perm = torch.randperm(n_real, generator=gen, device=dev)
                words[i, :n_real] = words[i, :n_real][perm]
                ldoc[i, :n_real] = ldoc[i, :n_real][perm]
        z = torch.randint(0, k, (nb, t), generator=gen, device=dev,
                          dtype=torch.int32)
        u = torch.rand((nb, t), generator=gen, device=dev)
        nkd = torch.zeros((nb, bd, k), device=dev)
        blk = torch.arange(nb, device=dev)[:, None].expand(nb, t)
        nkd.index_put_((blk.reshape(-1), ldoc.reshape(-1).long(),
                        z.reshape(-1).long()), mask.reshape(-1),
                       accumulate=True)
        nkv = torch.zeros((k, v), device=dev)
        nkv.index_put_((z.reshape(-1).long(), words.reshape(-1).long()),
                       mask.reshape(-1), accumulate=True)
        glob = torch.tensor(rng.integers(0, 4, (k, v)), dtype=torch.float32,
                            device=dev)             # a store's summed counts
        prior = nkv + glob + cfg0.eta
        prior_k = nkv.sum(1) + glob.sum(1) + v * cfg0.eta
        idx = gibbs_ops.doc_index(ldoc, mask, bd)   # once per fit
        args = (words, ldoc, mask, u, z, nkd, prior, prior_k, cfg0.alpha,
                idx)
        z1, nkd1, nkv1 = gibbs_ops.gibbs_sweep(*args)
        z2, nkd2, nkv2 = gibbs_sweep_ref(*args[:-1])
        torch.cuda.synchronize()
        bad = int((z1 != z2).sum())
        real = int(mask.sum())
        doc_len = torch.zeros((nb, bd), device=dev)
        doc_len.index_put_((blk.reshape(-1), ldoc.reshape(-1).long()),
                           mask.reshape(-1), accumulate=True)
        if float(nkv1.sum()) != real or not torch.equal(nkd1.sum(2),
                                                        doc_len):
            raise AssertionError("gibbs_sweep lost or invented tokens")
        if bad or not (torch.equal(nkd1, nkd2) and torch.equal(nkv1, nkv2)):
            raise AssertionError(f"gibbs_sweep ({label}): {bad} of {real} "
                                 f"draws differ from the plain version")
        same_bits_5(gibbs_ops.gibbs_sweep, args, f"gibbs_sweep ({label})")
        errs.append(float((nkv1 - nkv2).abs().max()))
        chain = int((idx[0][1:] - idx[0][:-1]).max())
        log(f"[kernels] gibbs_sweep {label} docs={n_docs} K={k} V={v} "
            f"BD={bd} blocks={nb} T_max={t} longest chain={chain} tokens: "
            f"{bad} of {real} draws differ from the plain version (tol 0), "
            f"counts conserved, 5 calls the same bits")
        if label == "main":
            ms = time_ms(lambda: gibbs_ops.gibbs_sweep(*args), 20)
            per_call = time_ms(lambda: gibbs_ops.gibbs_sweep(*args[:-1]), 5)
            idx_ms = time_ms(lambda: gibbs_ops.doc_index(ldoc, mask, bd), 5)
            plain = time_ms(lambda: gibbs_sweep_ref(*args[:-1]), 1)
            t_sweep_s = ms * 1e-3
            log(f"[kernels] gibbs_sweep: {ms:.4f} ms a sweep with the fit's "
                f"index, {ms * 1e6 / chain:.0f} ns per chain step "
                f"({chain} steps); {per_call:.4f} ms building the index "
                f"per call (doc_index alone {idx_ms:.4f} ms)")
            # bytes: the (B, T) inputs, n_kd in and out, the snapshot,
            # z out and n_kv out once; operations: ~8 per topic per token
            n_bytes = 4 * (6 * nb * t + 2 * nb * bd * k + 2 * k * v + k)
            b_ms, b_by = bound_ms(n_bytes, 8 * k * real)
            fit_win = win
    report["gibbs_sweep"] = dict(
        name="gibbs_sweep", route="cuda",
        source="src/repro_torch/kernels/csrc/gibbs_sweep.cu",
        replaces="src/repro/kernels/gibbs_sweep/gibbs_sweep.py:88",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)

    # cgs_sweep_exact: one sweep of the exact scan over a 1,000-document
    # gap at the main path's widths (~58,000 tokens, the shape of the gs
    # path's host gaps), a stream of repeated words whose documents come
    # back (unsorted), and the edge shape
    errs = []
    t_token_s = None
    for label, n_docs, k, v, mean_len in [
            ("main", 1000, 100, 8192, 60),
            ("repeated words, revisited docs", 60, 100, 8192, 50),
            ("edge", 40, 6, 150, 12)]:
        part, _ = make_corpus(n_docs, v, k, mean_doc_len=mean_len, seed=3)
        toks = torch.tensor(part.tokens, device=dev)
        docs = torch.tensor(part.doc_ids, device=dev)
        if label.startswith("repeated"):
            # runs of one word, and the stream cut in blocks of 7 tokens
            # taken in a shuffled order, so documents recur out of order
            toks = toks[torch.arange(toks.shape[0], device=dev) // 3 * 3]
            order = torch.randperm((toks.shape[0] + 6) // 7, generator=gen,
                                   device=dev)
            pos = (order[:, None] * 7 + torch.arange(7, device=dev)).reshape(-1)
            pos = pos[pos < toks.shape[0]]
            toks, docs = toks[pos].contiguous(), docs[pos].contiguous()
            if not bool((docs[1:] < docs[:-1]).any()):
                raise AssertionError("the revisiting stream is sorted")
        t = toks.shape[0]
        z = torch.randint(0, k, (t,), generator=gen, device=dev,
                          dtype=torch.int32)
        u = torch.rand((t,), generator=gen, device=dev)
        ones = torch.ones(t, device=dev)
        nkd = torch.zeros((part.n_docs, k), device=dev)
        nkd.index_put_((docs.long(), z.long()), ones, accumulate=True)
        nkv = torch.zeros((k, v), device=dev)
        nkv.index_put_((z.long(), toks.long()), ones, accumulate=True)
        glob = torch.tensor(rng.integers(0, 4, (k, v)), dtype=torch.float32,
                            device=dev)
        args = (toks, docs, u, z, nkd, nkv, nkv.sum(1), glob, glob.sum(1),
                cfg0.alpha, cfg0.eta)
        # the fit's entry point: n_kv and the prior in (V, K)
        args_t = (toks, docs, u, z, nkd, nkv.t().contiguous(), nkv.sum(1),
                  glob.t().contiguous(), glob.sum(1), cfg0.alpha, cfg0.eta)
        z1, nkd1, nkv1, nk1 = gibbs_ops.cgs_sweep_exact(*args)
        # the plain version at this size is ~30 small launches a token,
        # tens of seconds: its one comparison call is also its timing
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        ev[0].record()
        z2, nkd2, nkv2, nk2 = cgs_sweep_exact_ref(*args)
        ev[1].record()
        torch.cuda.synchronize()
        bad = int((z1 != z2).sum())
        if float(nkv1.sum()) != t or not torch.equal(nkd1.sum(1), nkd.sum(1)) \
                or not torch.equal(nk1, nkv1.sum(1)):
            raise AssertionError("cgs_sweep_exact lost or invented tokens")
        if bad or not (torch.equal(nkd1, nkd2) and torch.equal(nkv1, nkv2)
                       and torch.equal(nk1, nk2)):
            raise AssertionError(f"cgs_sweep_exact ({label}): {bad} of {t} "
                                 f"draws differ from the plain version")
        zt, nkdt, nkvt, nkt = gibbs_ops.cgs_sweep_exact_t(*args_t)
        if not (torch.equal(zt, z1) and torch.equal(nkdt, nkd1)
                and torch.equal(nkvt.t(), nkv1) and torch.equal(nkt, nk1)):
            raise AssertionError("cgs_sweep_exact_t disagrees with "
                                 "cgs_sweep_exact")
        same_bits_5(gibbs_ops.cgs_sweep_exact_t, args_t,
                    f"cgs_sweep_exact ({label})")
        errs.append(float((nkv1 - nkv2).abs().max()))
        log(f"[kernels] cgs_sweep_exact {label} docs={n_docs} K={k} V={v} "
            f"T={t} (the chain): {bad} of {t} draws differ from the plain "
            f"version (tol 0), counts conserved, 5 calls the same bits")
        if label == "main":
            ms = time_ms(lambda: gibbs_ops.cgs_sweep_exact_t(*args_t), 5)
            public = time_ms(lambda: gibbs_ops.cgs_sweep_exact(*args), 3)
            plain = ev[0].elapsed_time(ev[1])
            t_token_s = ms * 1e-3 / t
            log(f"[kernels] cgs_sweep_exact: {ms:.3f} ms a sweep in the "
                f"fit's (V, K) layout, {ms * 1e6 / t:.0f} ns per chain step "
                f"({t} steps); {public:.3f} ms through the (K, V) entry "
                f"point (two transposes)")
            n_bytes = 4 * (5 * t + 2 * part.n_docs * k + 3 * k * v + 3 * k)
            b_ms, b_by = bound_ms(n_bytes, 10 * k * t)
            fit_part = part
    report["cgs_sweep_exact"] = dict(
        name="cgs_sweep_exact", route="cuda",
        source="src/repro_torch/kernels/csrc/gibbs_sweep.cu",
        replaces="src/repro/core/gibbs.py:34",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)

    # whole fits of a 1,000-document window, wall (host clock after a
    # synchronise) beside the sum of their kernel times: the host's share
    fcfg = LDAConfig()
    fgen = torch.Generator(device=dev).manual_seed(1)
    for fit, fdata, per_sweep in (
            (cgs_fit_blocked, fit_win, report["gibbs_sweep"]["ms"]),
            (cgs_fit, fit_part, report["cgs_sweep_exact"]["ms"])):
        fit(fdata.tokens, fdata.doc_ids, fcfg, fgen, sweeps=2)   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fit(fdata.tokens, fdata.doc_ids, fcfg, fgen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if float(out.sum()) != fdata.n_tokens:
            raise AssertionError(f"{fit.__name__} lost or invented tokens")
        kern = fcfg.gibbs_sweeps * per_sweep
        log(f"[kernels] {fit.__name__} of a 1,000-document window "
            f"({fdata.n_tokens} tokens, {fcfg.gibbs_sweeps} sweeps): "
            f"{wall:.2f} ms wall, {kern:.2f} ms of sweep kernels "
            f"({fcfg.gibbs_sweeps} x {per_sweep:.4f}), host share "
            f"{(wall - kern) / wall:.1%}")

    # flash_attention and decode_attention run on the tensor cores in bf16
    # (mma.sync): the SASS of every bf16 instance must hold HMMA or HGMMA
    tc_sass = tensor_core_instructions(common.library_path())
    for kname, ops in (("flash_fwd_bf16", flash_ops),
                       ("decode_partial_bf16", decode_ops)):
        found = {fn: n for fn, n in tc_sass.items() if kname in fn}
        if len(found) != len(ops.HEAD_DIMS) or min(found.values()) == 0:
            raise AssertionError(f"{kname}: tensor-core instructions per "
                                 f"instance {found}")
        log(f"[kernels] {kname}: {len(found)} instances, HMMA/HGMMA per "
            f"instance {sorted(found.values())}")
    sass_hmma = {k: sum(n for fn, n in tc_sass.items() if k in fn)
                 for k in ("flash_fwd_bf16", "decode_partial_bf16")}

    # flash_attention: the serve path's prefill shape (qwen3-1.7b heads,
    # causal) on both instances, bf16 (tensor cores, the served dtype) and
    # f32 (CUDA cores), each timed, then an edge (ragged S, window, f32).
    # Both instances are held to the plain version run in float32 on the
    # same inputs, at (atol, rtol): the JAX kernel tests' 1e-5 in f32; in
    # bf16 a limit with headroom over what rounding p and the output to
    # bf16 costs, tight enough that a KV tile or split skipped for the
    # late rows, whose outputs are ~0.05, fails it
    # (tests/test_torch_attention.py); "atol used" is the atol this run's
    # result needs at that rtol, the headroom's reading.
    import torch.nn.functional as F
    attn_tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (5e-3, 1e-2)}

    def attn_close(got, want, dt):
        atol, rtol = attn_tol[dt]
        err = close(got.float(), want, atol, rtol)
        used = float(((got.float() - want).abs() - rtol * want.abs()).max())
        return err, f"max abs err {err:.3g}, atol used {used:.3g} of {atol} " \
                    f"at rtol {rtol}"

    peak = {torch.float32: PEAK_F32_FLOPS, torch.bfloat16: PEAK_BF16_TC_FLOPS}
    dt_name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    errs = []
    inst = {}
    for b, s, h, kvh, hd, window, dt in [
            (SERVE_B, SERVE_PROMPT, 16, 8, 128, 0, torch.bfloat16),
            (SERVE_B, SERVE_PROMPT, 16, 8, 128, 0, torch.float32),
            (1, 200, 4, 2, 128, 50, torch.float32)]:
        q, k, v = (torch.tensor(rng.normal(size=(b, s, n, hd)),
                                dtype=torch.float32, device=dev).to(dt)
                   for n in (h, kvh, kvh))
        got = flash_ops.flash_attention(q, k, v, causal=True, window=window)
        want = flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=True, window=window)
        err, msg = attn_close(got, want, dt)
        errs.append(err)
        log(f"[kernels] flash_attention B={b} S={s} H={h} KVH={kvh} hd={hd} "
            f"window={window} {dt}: {msg}")
        del want
        if s == SERVE_PROMPT:
            if dt == torch.bfloat16:
                for _ in range(5):
                    if not torch.equal(flash_ops.flash_attention(q, k, v),
                                       got):
                        raise AssertionError("bf16 flash_attention gives "
                                             "other bits on a repeat call")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            ms = time_ms(lambda: flash_ops.flash_attention(q, k, v), 10)
            plain = time_ms(lambda: flash_attention_ref(q, k, v), 3)
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 10)
            # bytes: q, k, v read once, out written once; operations: the
            # causal pairs this call has, 4·hd flops each (QK and PV),
            # against the bf16 tensor-core peak (bf16) or the fp32 peak
            # (f32: TF32 would not keep the tolerance)
            n_bytes = q.element_size() * (2 * b * s * h * hd
                                          + 2 * b * s * kvh * hd)
            n_ops = 4 * hd * b * h * s * (s + 1) / 2
            b_ms, b_by = bound_ms(n_bytes, n_ops, peak[dt])
            inst[dt] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib)
            log(f"[kernels] flash_attention {dt}: {ms:.4f} ms, "
                f"{n_ops / 1e9:.2f} GFLOP, "
                f"{n_ops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
                f"{n_bytes / (ms * 1e-3) / 1e12:.3f} TB/s; bound {b_ms:.4f} "
                f"ms ({b_by}); plain {plain:.3f} ms; SDPA {lib:.4f} ms"
                + ("; same bits over 5 calls" if dt == torch.bfloat16
                   else ""))
    report["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:85",
        max_abs_err=max(errs), **inst[torch.bfloat16],
        instances={dt_name[d]: v for d, v in inst.items()},
        sass_hmma=sass_hmma["flash_fwd_bf16"])

    # decode_attention: the serve path's decode shape at pos 2,100 of a
    # 2,112-position cache in bf16 (tensor cores) and again in f32 (CUDA
    # cores; 11 splits, so f32 at 1e-5 holds the split-K combine), each
    # timed, then one sequence (B = 1) at qwen3's heads and at gemma-2b's
    # MQA (the split plan adapts to B·KVH: each also timed with the plan of
    # the served B·KVH = 32), then windows (f32): at pos 0 (one live key)
    # and at pos 300 (64 keys across two splits)
    errs = []
    inst = {}
    single = {}
    for b, s, h, kvh, hd, pos, window, dt in [
            (SERVE_B, SERVE_CACHE, 16, 8, 128, 2100, 0, torch.bfloat16),
            (SERVE_B, SERVE_CACHE, 16, 8, 128, 2100, 0, torch.float32),
            (1, SERVE_CACHE, 16, 8, 128, 2100, 0, torch.bfloat16),
            (1, SERVE_CACHE, 8, 1, 256, 2100, 0, torch.bfloat16),
            (1, 512, 4, 2, 128, 0, 64, torch.float32),
            (1, 512, 4, 2, 128, 300, 64, torch.float32)]:
        q = torch.tensor(rng.normal(size=(b, 1, h, hd)), dtype=torch.float32,
                         device=dev).to(dt)
        kc, vc = (torch.tensor(rng.normal(size=(b, s, kvh, hd)),
                               dtype=torch.float32, device=dev).to(dt)
                  for _ in range(2))
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        got = decode_ops.decode_attention(q, kc, vc, p, window=window)
        want = decode_attention_ref(q.float(), kc.float(), vc.float(), pos,
                                    window=window)
        err, msg = attn_close(got, want, dt)
        errs.append(err)
        n_split, chunk = decode_ops.split_plan(s, b * kvh)
        log(f"[kernels] decode_attention B={b} S={s} H={h} KVH={kvh} "
            f"hd={hd} pos={pos} window={window} {dt} ({n_split} splits of "
            f"{chunk}): {msg}")
        if pos != 2100:
            continue
        if dt == torch.bfloat16:
            for _ in range(5):
                if not torch.equal(decode_ops.decode_attention(q, kc, vc, p),
                                   got):
                    raise AssertionError("bf16 decode_attention gives other "
                                         "bits on a repeat call")
        qt = q.transpose(1, 2)
        kt, vt = (x[:, :pos + 1].transpose(1, 2) for x in (kc, vc))
        ms = time_ms(lambda: decode_ops.decode_attention(q, kc, vc, p), 20)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True), 20)
        # bytes: the pos + 1 live cache rows of k and v, q, out;
        # operations: 4·hd flops per (head, live key)
        n_bytes = q.element_size() * (2 * b * (pos + 1) * kvh * hd
                                      + 2 * b * h * hd)
        n_ops = 4 * hd * b * h * (pos + 1)
        b_ms, b_by = bound_ms(n_bytes, n_ops, peak[dt])
        rate = (f"{n_bytes / 1e6:.1f} MB, "
                f"{n_bytes / (ms * 1e-3) / 1e12:.3f} TB/s, "
                f"{n_ops / (ms * 1e-3) / 1e12:.3f} TFLOP/s; bound {b_ms:.4f} "
                f"ms ({b_by}); SDPA {lib:.4f} ms")
        if b == 1:
            plan = decode_ops.split_plan
            decode_ops.split_plan = lambda s_, _: plan(s_, SERVE_B * 8)
            try:
                served_plan = time_ms(
                    lambda: decode_ops.decode_attention(q, kc, vc, p), 20)
            finally:
                decode_ops.split_plan = plan
            single[f"B=1 H={h} KVH={kvh} hd={hd}"] = dict(
                ms=ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                ms_served_plan=served_plan)
            log(f"[kernels] decode_attention B=1 H={h} KVH={kvh} hd={hd} "
                f"{dt}: {ms:.4f} ms, {rate}; with the served B·KVH's plan "
                f"({'%d splits of %d' % plan(s, SERVE_B * 8)}) "
                f"{served_plan:.4f} ms")
            continue
        plain = time_ms(lambda: decode_attention_ref(q, kc, vc, pos), 20)
        inst[dt] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                        library_ms=lib)
        log(f"[kernels] decode_attention {dt}: {ms:.4f} ms, {rate}; plain "
            f"{plain:.4f} ms"
            + ("; same bits over 5 calls" if dt == torch.bfloat16 else ""))
    report["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention/decode_attention.py:71",
        max_abs_err=max(errs), **inst[torch.bfloat16],
        instances={dt_name[d]: v for d, v in inst.items()},
        single_sequence=single, sass_hmma=sass_hmma["decode_partial_bf16"])

    # slstm_scan: the JAX kernel tests' shapes (f32 R: the cooperative
    # route, 1e-5), an odd shape in f32 and bf16 R and decode steps (S = 1,
    # the step route, with the served bf16 xpre and R among them) from a
    # nonzero state (1e-5), the cluster route's batch chunks and groups
    # (B = 9) and 16 heads in waves, then the served shape (xlstm-1.3b:
    # B = 4, S = 2,048, H = 4,
    # hd = 512) with the model's bf16 R (cluster route) and with an f32 R
    # (cooperative route) (1e-4: 2,048 dependent steps), and in the
    # model's own dtypes (bf16 xpre and R; h comes back in bf16 and is
    # held to one bf16 rounding, 2^-7, the final state to 1e-4)
    def slstm_inputs(b, s, h, hd, x_dt, r_dt, nonzero):
        xpre = (torch.tensor(rng.normal(size=(b, s, 4, h, hd)),
                             dtype=torch.float32, device=dev) * 0.5).to(x_dt)
        r = (torch.tensor(rng.normal(size=(h, hd, 4 * hd)),
                          dtype=torch.float32, device=dev)
             * hd ** -0.5).to(r_dt)
        if not nonzero:
            return xpre, r, zero_state(b, h, hd, dev)
        st = [torch.tensor(a, dtype=torch.float32, device=dev) for a in (
            rng.normal(size=(b, h, hd)), rng.uniform(0.5, 2.0, (b, h, hd)),
            rng.normal(size=(b, h, hd)) * 0.5, rng.normal(size=(b, h, hd)))]
        return xpre, r, tuple(st)

    def slstm_plan(b, s, h, hd, r_dt):
        p = slstm_ops.scan_plan(b, s, h, hd, r_dt)
        return (f"{p.route} route, {p.ctas} CTAs a head of {p.units} units"
                + (f", {p.rows} rows a cluster x {p.groups}, {p.smem} B of "
                   f"shared memory" if p.route == "cluster" else ""))

    f32, bf16 = torch.float32, torch.bfloat16
    errs = []
    for b, s, h, hd, x_dt, r_dt, nonzero, tol in [
            (2, 32, 2, 16, f32, f32, False, 1e-5),
            (4, 64, 4, 32, f32, f32, False, 1e-5),
            (1, 48, 3, 8, f32, f32, False, 1e-5),
            (1, 33, 3, 8, f32, f32, True, 1e-5),
            (1, 33, 3, 8, f32, bf16, True, 1e-5),
            (XL_B, 1, XL_H, XL_HD, f32, bf16, True, 1e-5),
            (XL_B, 1, XL_H, XL_HD, bf16, bf16, True, 1e-5),
            (8, 1, XL_H, XL_HD, f32, f32, True, 1e-5),
            (9, 64, XL_H, XL_HD, f32, bf16, True, 1e-5),
            (1, 64, 16, XL_HD, f32, bf16, True, 1e-5),
            (XL_B, XL_S, XL_H, XL_HD, f32, bf16, False, 1e-4),
            (XL_B, XL_S, XL_H, XL_HD, f32, f32, False, 1e-4),
            (XL_B, XL_S, XL_H, XL_HD, bf16, bf16, False, 1e-4)]:
        xpre, r, st = slstm_inputs(b, s, h, hd, x_dt, r_dt, nonzero)
        got, got_st = slstm_ops.slstm_scan(xpre, r, *st)
        want, want_st = slstm_scan_ref(xpre, r, *st)
        h_tol = tol if x_dt == f32 else 2.0 ** -7
        err_h = close(got.float(), want.float(), h_tol)
        err_st = max(close(g, w, tol) for g, w in zip(got_st, want_st))
        errs.append(max(err_h, err_st))
        log(f"[kernels] slstm_scan B={b} S={s} H={h} hd={hd} xpre {x_dt} R "
            f"{r_dt}{' from a nonzero state' if nonzero else ''} "
            f"({slstm_plan(b, s, h, hd, r_dt)}): max abs err h {err_h:.3g} "
            f"(tol {h_tol:.3g}), final state {err_st:.3g} (tol {tol})")
        del want, want_st

    def slstm_bound(b, s, h, hd, x_el, r_el):
        # bytes: xpre and R read once, h_out written once, the state read
        # and written once; operations: the h·R products (2·hd·4hd per
        # row, step and head) and ~20 f32 operations per unit for the
        # gates.  With bf16 R the f32 product is exact as three bf16
        # products on the tensor cores (h = hi + mid + lo), so it is
        # bounded at a third of their peak; with f32 R at the f32 peak
        n_bytes = (b * s * 4 * h * hd * x_el + h * hd * 4 * hd * r_el
                   + b * s * h * hd * x_el + 8 * 4 * b * h * hd)
        prod = 2 * b * s * h * hd * 4 * hd
        t_prod = (3 * prod / PEAK_BF16_TC_FLOPS if r_el == 2
                  else prod / PEAK_F32_FLOPS)
        t_ops = (t_prod + 20 * b * s * h * hd / PEAK_F32_FLOPS) * 1e3
        t_bytes = n_bytes / PEAK_BYTES_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    # the timed calls, one a route: the served prefill call in the model's
    # dtypes (cluster), a decode step (step) and the prefill call with an
    # f32 R (cooperative); each bitwise repeatable over five calls
    inst = {}
    for route, s, x_dt, r_dt, nonzero, reps, plain_reps in [
            ("cluster", XL_S, bf16, bf16, False, 10, 1),
            ("step", 1, bf16, bf16, True, 20, 20),
            ("coop", XL_S, f32, f32, False, 5, 1)]:
        if slstm_ops.scan_plan(XL_B, s, XL_H, XL_HD, r_dt).route != route:
            raise AssertionError(f"slstm_scan: the {route} shape planned "
                                 f"{slstm_plan(XL_B, s, XL_H, XL_HD, r_dt)}")
        xpre, r, st = slstm_inputs(XL_B, s, XL_H, XL_HD, x_dt, r_dt, nonzero)
        first = slstm_ops.slstm_scan(xpre, r, *st)
        for _ in range(5):
            again = slstm_ops.slstm_scan(xpre, r, *st)
            if not (torch.equal(again[0], first[0]) and all(
                    torch.equal(a, g) for a, g in zip(again[1], first[1]))):
                raise AssertionError(f"slstm_scan {route} route: two calls "
                                     f"gave different bits")
        ms = time_ms(lambda: slstm_ops.slstm_scan(xpre, r, *st), reps)
        plain = time_ms(lambda: slstm_scan_ref(xpre, r, *st), plain_reps)
        b_ms, b_by = slstm_bound(XL_B, s, XL_H, XL_HD, xpre.element_size(),
                                 r.element_size())
        inst[route] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                           bound_by=b_by, library_ms=None)
        log(f"[kernels] slstm_scan {route} route, B={XL_B} S={s} H={XL_H} "
            f"hd={XL_HD} xpre {x_dt} R {r_dt}: {ms:.4f} ms"
            + (f" = {ms / s * 1e3:.3f} us per dependent step" if s > 1
               else "")
            + f"; bound {b_ms:.4f} ms ({b_by}); plain {plain:.4f} ms; same "
            f"bits over 5 calls")
        del xpre, r, st, first, again
    # each route's step with almost no work, S = 2,048 (the step route:
    # one call): one CTA (B = 1, H = 1, hd = 16), one head of 16 CTAs
    # (cluster, hd = 512 bf16) or 32 CTAs (cooperative, hd = 512 f32) at
    # B = 1
    floors = {}
    for label, s, hd, r_dt in [("cluster, one CTA", XL_S, 16, bf16),
                               ("cluster, one head of 16 CTAs", XL_S,
                                XL_HD, bf16),
                               ("coop, one head of 32 CTAs", XL_S, XL_HD,
                                f32),
                               ("step, one CTA", 1, 16, bf16)]:
        xf, rf, stf = slstm_inputs(1, s, 1, hd, r_dt, r_dt, False)
        floors[label] = time_ms(
            lambda: slstm_ops.slstm_scan(xf, rf, *stf), 5 if s > 1 else 20)
        log(f"[kernels] slstm_scan latency floor ({label}, "
            f"{slstm_plan(1, s, 1, hd, r_dt)}): {floors[label]:.4f} ms"
            + (f" = {floors[label] / s * 1e3:.3f} us a step" if s > 1
               else " a call"))
        del xf, rf, stf
    occupancy = {f"{k[0]} P={k[1]} rows={k[3]} smem={k[4]}": n
                 for k, n in slstm_ops.cluster_occupancy.items()}
    log(f"[kernels] slstm_scan max active clusters "
        f"(cudaOccupancyMaxActiveClusters, queried once per configuration): "
        f"{occupancy}")
    report["slstm_scan"] = dict(
        name="slstm_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/slstm_scan.cu",
        replaces="src/repro/kernels/slstm_scan/slstm_scan.py:82",
        max_abs_err=max(errs), **inst["cluster"], instances=inst,
        floors_ms=floors, max_active_clusters=occupancy)

    for rep in report.values():
        log(f"[kernels] {rep['name']}: kernel {rep['ms']:.4f} ms, plain "
            f"{rep['plain_ms']:.4f} ms, library {rep['library_ms']} ms, "
            f"bound {rep['bound_ms']:.4f} ms ({rep['bound_by']}) on {card}")
    del flush
    torch.cuda.empty_cache()

    # -- 3. the main path ---------------------------------------------------
    cfg = LDAConfig()
    n_trains = N_WINDOWS + 2           # windows, plus two half-window gaps
    iters = min(cfg.max_iters,
                max(5, int(TRAIN_BUDGET_S / (n_trains * t_estep_s))))
    if iters < cfg.max_iters:
        log(f"[main] cut: max_iters {cfg.max_iters} -> {iters} (E-step "
            f"{t_estep_s * 1e3:.1f} ms at D=2048, {TRAIN_BUDGET_S:.0f} s "
            f"training budget)")
        cfg = dataclasses.replace(cfg, max_iters=iters)
    else:
        log(f"[main] no cut: max_iters stays {cfg.max_iters} (E-step "
            f"{t_estep_s * 1e3:.1f} ms at D=2048 fits the "
            f"{TRAIN_BUDGET_S:.0f} s training budget); widths and corpus "
            f"size are never cut")
    log(f"[main] LDAConfig K={cfg.n_topics} V={cfg.vocab_size} "
        f"max_iters={cfg.max_iters} e_step_iters={cfg.e_step_iters}")
    t0 = time.perf_counter()
    corpus, beta_true = make_corpus(32_000, cfg.vocab_size, cfg.n_topics,
                                    mean_doc_len=60, seed=0)
    log(f"[main] corpus: {corpus.n_docs} docs, {corpus.n_tokens} tokens in "
        f"{time.perf_counter() - t0:.1f} s (host)")

    session = MLegoSession(corpus, cfg, backend="device", device="cuda")
    merge_ops.merge_topics_launches = 0
    merge_ops.merge_topics_ragged_launches = 0
    estep_ops.launches = 0

    t0 = time.perf_counter()
    for i in range(N_WINDOWS):
        m = session.train_range(i * 1000.0, (i + 1) * 1000.0)
        if m is None or m.n_docs == 0:
            raise AssertionError(f"window {i} holds no documents")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    resident = session.backend.cache.resident_bytes
    log(f"[main] train_range x{N_WINDOWS}: {t_train:.1f} s, "
        f"{len(session.store)} models, {resident / 1e6:.1f} MB resident")

    covered = QuerySpec(sigma=Interval(0.0, 8000.0))
    t0 = time.perf_counter()
    rep_cov = session.submit(covered)
    log(f"[main] submit covered [0, 8000): {len(rep_cov.model_ids)} parts, "
        f"{rep_cov.n_trained_tokens} trained tokens, "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, merge "
        f"{rep_cov.merge_device_ms:.2f} ms")
    t0 = time.perf_counter()
    rep_gap = session.submit(QuerySpec(sigma=Interval(8500.0, 12500.0)))
    log(f"[main] submit with gaps [8500, 12500): {rep_gap.n_merged} parts, "
        f"{rep_gap.n_trained_tokens} trained tokens, "
        f"{(time.perf_counter() - t0):.2f} s")
    specs = [QuerySpec(sigma=Interval(0.0, 4000.0)),
             QuerySpec(sigma=Interval(4000.0, 6000.0)),
             QuerySpec(sigma=Interval(16000.0, 24000.0)),
             QuerySpec(sigma=Interval(24000.0, 25000.0))]
    t0 = time.perf_counter()
    batch = session.submit_many(specs)
    log(f"[main] submit_many parts={[r.n_merged for r in batch]}: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, merge "
        f"{batch.merge_device_ms:.2f} ms, pad rows {batch.pad_rows}")
    torch.cuda.synchronize()
    launches = {"merge_topics": merge_ops.merge_topics_launches,
                "merge_topics_ragged": merge_ops.merge_topics_ragged_launches,
                "vb_estep": estep_ops.launches}
    log(f"[main] kernel launches on the main path: {launches}")
    for kname, count in launches.items():
        if count <= 0:
            raise AssertionError(f"main path never launched {kname}")
        report[kname]["launches"] = count
        report[kname]["launches_by_path"] = {"vb": count}

    if rep_gap.n_trained_tokens <= 0:
        raise AssertionError("the gap query trained no tokens")
    if len([r for r in batch]) != len(specs) or \
            len({r.n_merged for r in batch}) < 3:
        raise AssertionError("submit_many did not merge ragged part counts")
    for r in [rep_cov, rep_gap, *batch]:
        if r.backend != "device" or r.fallback_from is not None:
            raise AssertionError(f"report answered by {r.backend} "
                                 f"(fallback from {r.fallback_from})")
        if r.beta.shape != (cfg.n_topics, cfg.vocab_size) \
                or not np.isfinite(r.beta).all():
            raise AssertionError("beta is not finite (K, V)")
        row_err = float(np.abs(r.beta.sum(1) - 1.0).max())
        if row_err > 1e-5:
            raise AssertionError(f"beta rows sum to 1 +- {row_err}")

    host = MLegoSession(corpus, cfg, store=session.store, backend="host",
                        device="cuda")
    rep_host = host.submit(covered)
    if rep_host.model_ids != rep_cov.model_ids:
        raise AssertionError("host and device planned different parts")
    diff = float(np.abs(rep_host.beta - rep_cov.beta).max())
    if not np.allclose(rep_cov.beta, rep_host.beta, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"device beta differs from host by {diff}")
    log(f"[main] covered beta: device vs host max abs diff {diff:.3g} "
        f"(tol 1e-5)")

    # in-sample fit of the covered answer against the generating topics
    x_in = doc_term_matrix(corpus, 0, 300).astype(np.float64)
    lpp = log_predictive_probability(rep_cov.beta, x_in, cfg.alpha)
    lpp_true = log_predictive_probability(beta_true, x_in, cfg.alpha)
    lpp_flat = log_predictive_probability(
        np.full_like(rep_cov.beta, 1.0 / cfg.vocab_size), x_in, cfg.alpha)
    log(f"[main] per-token log predictive (300 docs of [0, 8000)): merged "
        f"{lpp:.4f}, generating topics {lpp_true:.4f}, uniform "
        f"{lpp_flat:.4f}")
    if not lpp > lpp_flat:
        raise AssertionError("merged topics fit no better than uniform")

    # -- 4. the other gap routes on the card --------------------------------
    # the "host" backend's trainer, and a replay on it after the device
    # backend lost its device, must run the E-step kernel too
    from repro_torch.testing.faults import FaultRule, injected
    before = estep_ops.launches
    rep = host.submit(QuerySpec(sigma=Interval(20500.0, 21500.0)))
    host_launches = estep_ops.launches - before
    if rep.n_trained_tokens <= 0 or host_launches <= 0:
        raise AssertionError(f"host gap route launched the E-step kernel "
                             f"{host_launches} times")
    replay = MLegoSession(corpus, cfg, store=session.store, backend="device",
                          device="cuda")
    before = estep_ops.launches
    with injected(FaultRule("backend.train_gap.device", kind="device_lost",
                            max_failures=1)):
        rep2 = replay.submit(QuerySpec(sigma=Interval(28500.0, 29500.0)))
    replay_launches = estep_ops.launches - before
    if (rep2.backend, rep2.fallback_from) != ("host", "device") \
            or replay_launches <= 0:
        raise AssertionError(
            f"device-lost replay answered by {rep2.backend} (from "
            f"{rep2.fallback_from}) with {replay_launches} E-step launches")
    for r in (rep, rep2):
        if not np.isfinite(r.beta).all():
            raise AssertionError("beta of a host-trained gap is not finite")
    log(f"[routes] host gap query: {rep.n_trained_tokens} trained tokens, "
        f"{host_launches} E-step launches; device-lost replay on host: "
        f"{rep2.n_trained_tokens} trained tokens, {replay_launches} E-step "
        f"launches")

    # -- 5. the "gs" path ---------------------------------------------------
    # the same corpus and widths; collapsed Gibbs with the DSGS prior.
    # Gaps on "device" train with the blocked sweep, on "host" (and in a
    # replay after device loss) with the exact scan.
    gcfg = LDAConfig()
    n_gs = GS_WINDOWS
    # a window is gibbs_sweeps blocked sweeps at the phase-2 shape; cut
    # windows (never widths) if that rate would overrun the budget
    est = gcfg.gibbs_sweeps * t_sweep_s
    if n_gs * est > GS_TRAIN_BUDGET_S:
        n_gs = max(4, int(GS_TRAIN_BUDGET_S / est))
        log(f"[gs] cut: {GS_WINDOWS} -> {n_gs} windows ({est:.2f} s per "
            f"window at the measured blocked-sweep rate)")
    else:
        log(f"[gs] no cut: {n_gs} windows at ~{est:.2f} s each (blocked "
            f"sweep {t_sweep_s * 1e3:.2f} ms); an exact-scan gap of 60,000 "
            f"tokens ~{gcfg.gibbs_sweeps * 60_000 * t_token_s:.1f} s "
            f"({t_token_s * 1e6:.2f} us per token)")
    gs = MLegoSession(corpus, gcfg, kind="gs", backend="device",
                      device="cuda")
    for counter in ("merge_topics_launches", "merge_topics_ragged_launches",
                    "merge_topics_batch_launches"):
        setattr(merge_ops, counter, 0)
    gibbs_ops.gibbs_sweep_launches = 0
    gibbs_ops.cgs_sweep_exact_launches = 0

    t0 = time.perf_counter()
    for i in range(n_gs):
        m = gs.train_range(i * 1000.0, (i + 1) * 1000.0)
        if m is None or m.kind != "gs" or \
                float(m.theta["delta_nkv"].sum()) != m.n_tokens:
            raise AssertionError(f"gs window {i} did not conserve its tokens")
    torch.cuda.synchronize()
    log(f"[gs] train_range x{n_gs}: {time.perf_counter() - t0:.1f} s, "
        f"train_device_ms {gs.backend.stats.train_device_ms:.0f} over "
        f"{gs.backend.stats.gap_device_trains} fits")
    t0 = time.perf_counter()
    g_cov = gs.submit(covered)
    log(f"[gs] submit covered [0, 8000): {len(g_cov.model_ids)} parts, "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, merge "
        f"{g_cov.merge_device_ms:.2f} ms")
    t0 = time.perf_counter()
    g_gap = gs.submit(QuerySpec(sigma=Interval(8500.0, 12500.0)))
    log(f"[gs] submit with gaps [8500, 12500): {g_gap.n_merged} parts, "
        f"{g_gap.n_trained_tokens} trained tokens, "
        f"{time.perf_counter() - t0:.2f} s, train_device_ms "
        f"{g_gap.train_device_ms:.0f}")
    g_specs = [QuerySpec(sigma=Interval(0.0, 4000.0)),
               QuerySpec(sigma=Interval(4000.0, 6000.0)),
               QuerySpec(sigma=Interval(0.0, 8000.0)),
               QuerySpec(sigma=Interval(2000.0, 3000.0))]
    t0 = time.perf_counter()
    g_batch = gs.submit_many(g_specs)
    log(f"[gs] submit_many parts={[r.n_merged for r in g_batch]}: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, merge "
        f"{g_batch.merge_device_ms:.2f} ms, pad rows {g_batch.pad_rows}")
    if g_gap.n_trained_tokens <= 0:
        raise AssertionError("the gs gap query trained no tokens")
    if len({r.n_merged for r in g_batch}) < 3:
        raise AssertionError("gs submit_many did not merge ragged part "
                             "counts")
    blocked_launches = gibbs_ops.gibbs_sweep_launches

    # the "host" backend trains an untrained range with the exact scan;
    # a device-lost replay on "host" does too
    g_host = MLegoSession(corpus, gcfg, kind="gs", store=gs.store,
                          backend="host", device="cuda")
    t0 = time.perf_counter()
    g_hrep = g_host.submit(QuerySpec(sigma=Interval(20500.0, 21500.0)))
    t_host = time.perf_counter() - t0
    host_exact = gibbs_ops.cgs_sweep_exact_launches
    g_replay = MLegoSession(corpus, gcfg, kind="gs", store=gs.store,
                            backend="device", device="cuda")
    t0 = time.perf_counter()
    with injected(FaultRule("backend.train_gap.device", kind="device_lost",
                            max_failures=1)):
        g_rrep = g_replay.submit(QuerySpec(sigma=Interval(28500.0, 29500.0)))
    t_replay = time.perf_counter() - t0
    torch.cuda.synchronize()
    g_launches = {
        "gibbs_sweep": gibbs_ops.gibbs_sweep_launches,
        "cgs_sweep_exact": gibbs_ops.cgs_sweep_exact_launches,
        "merge_topics": merge_ops.merge_topics_launches,
        "merge_topics_ragged": merge_ops.merge_topics_ragged_launches}
    log(f"[gs] host gap query [20500, 21500): {g_hrep.n_trained_tokens} "
        f"trained tokens, {host_exact} exact-scan launches, {t_host:.2f} s; "
        f"device-lost replay [28500, 29500) on {g_rrep.backend}: "
        f"{g_rrep.n_trained_tokens} trained tokens, "
        f"{g_launches['cgs_sweep_exact'] - host_exact} exact-scan launches, "
        f"{t_replay:.2f} s")
    log(f"[gs] kernel launches on the gs path: {g_launches}")
    for kname, count in g_launches.items():
        if count <= 0:
            raise AssertionError(f"gs path never launched {kname}")
    if blocked_launches != gibbs_ops.gibbs_sweep_launches:
        raise AssertionError("a host-trained gs gap launched the blocked "
                             "sweep")
    if host_exact <= 0 or g_launches["cgs_sweep_exact"] <= host_exact:
        raise AssertionError("a host-trained gs gap did not launch the "
                             "exact scan")
    for kname, count in g_launches.items():
        by_path = report[kname].setdefault("launches_by_path", {})
        by_path["gs"] = count
        report[kname]["launches"] = sum(by_path.values())
    # the batched merge is the ragged path's retired parity reference:
    # no entry point of either path reaches it
    report["merge_topics_batch"]["launches"] = \
        merge_ops.merge_topics_batch_launches

    expect = [(g_cov, "device", None), (g_gap, "device", None),
              *[(r, "device", None) for r in g_batch],
              (g_hrep, "host", None), (g_rrep, "host", "device")]
    for r, backend, fallback in expect:
        if (r.backend, r.fallback_from) != (backend, fallback):
            raise AssertionError(f"gs report answered by {r.backend} "
                                 f"(fallback from {r.fallback_from}), "
                                 f"expected {backend} ({fallback})")
        if r.beta.shape != (gcfg.n_topics, gcfg.vocab_size) \
                or not np.isfinite(r.beta).all():
            raise AssertionError("gs beta is not finite (K, V)")
        row_err = float(np.abs(r.beta.sum(1) - 1.0).max())
        if row_err > 1e-5:
            raise AssertionError(f"gs beta rows sum to 1 +- {row_err}")
    if g_hrep.n_trained_tokens <= 0 or g_rrep.n_trained_tokens <= 0:
        raise AssertionError("a host gs gap trained no tokens")
    g_hcov = g_host.submit(covered)
    diff = float(np.abs(g_hcov.beta - g_cov.beta).max())
    if g_hcov.model_ids != g_cov.model_ids or not np.allclose(
            g_cov.beta, g_hcov.beta, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"gs device beta differs from host by {diff}")
    lpp = log_predictive_probability(g_cov.beta, x_in, gcfg.alpha)
    log(f"[gs] covered beta: device vs host max abs diff {diff:.3g} (tol "
        f"1e-5); per-token log predictive merged {lpp:.4f}, uniform "
        f"{lpp_flat:.4f}")
    if not lpp > lpp_flat:
        raise AssertionError("merged gs topics fit no better than uniform")

    # -- 6. the LM serving path at qwen3-1.7b full width ---------------------
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import make_batch
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model
    lcfg = get_arch("qwen3-1.7b")
    model = build_model(lcfg)
    t0 = time.perf_counter()
    masters = model.init(torch.Generator(device=dev).manual_seed(0))
    params = model.cast_params(masters)
    torch.cuda.synchronize()
    log(f"[serve] {lcfg.name}: {model.param_count(params) / 1e9:.3f} B "
        f"parameters ({lcfg.n_layers} layers, d_model {lcfg.d_model}, "
        f"{lcfg.n_heads}/{lcfg.n_kv_heads} heads of {lcfg.hd}, vocab "
        f"{lcfg.padded_vocab}), {lcfg.dtype}; init + cast "
        f"{time.perf_counter() - t0:.1f} s")
    batch = make_batch(lcfg, SERVE_B, SERVE_PROMPT, 0, 0)
    batch.pop("labels")
    # a short warm-up through the same entry point (cuBLAS heuristics,
    # allocator), not counted
    generate(model, params, batch, steps=2, cache_len=SERVE_CACHE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_ops.flash_attention_launches = 0
    decode_ops.decode_attention_launches = 0
    stats = {}
    toks = generate(model, params, batch, steps=SERVE_STEPS,
                    cache_len=SERVE_CACHE, stats=stats)
    s_launches = {"flash_attention": flash_ops.flash_attention_launches,
                  "decode_attention": decode_ops.decode_attention_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_gen = SERVE_B * SERVE_STEPS
    log(f"[serve] generate B={SERVE_B} prompt={SERVE_PROMPT} "
        f"cache_len={SERVE_CACHE} steps={SERVE_STEPS}: prefill "
        f"{stats['prefill_s']:.4f} s, decode {stats['decode_s']:.4f} s = "
        f"{stats['decode_s'] / SERVE_STEPS * 1e3:.3f} ms per step, "
        f"{n_gen / stats['decode_s']:.1f} generated tokens/s in decode, "
        f"{n_gen / (stats['prefill_s'] + stats['decode_s']):.1f} "
        f"end to end; peak memory allocated {peak_gb:.2f} GB")
    log(f"[serve] kernel launches on the serve path: {s_launches}")
    if s_launches["flash_attention"] != lcfg.n_layers:
        raise AssertionError(f"prefill launched the flash kernel "
                             f"{s_launches['flash_attention']} times, "
                             f"expected {lcfg.n_layers}")
    if s_launches["decode_attention"] != lcfg.n_layers * SERVE_STEPS:
        raise AssertionError(f"decode launched the decode kernel "
                             f"{s_launches['decode_attention']} times, "
                             f"expected {lcfg.n_layers * SERVE_STEPS}")
    if not stats["logits_finite"]:
        raise AssertionError("serve logits are not finite")
    if toks.shape != (SERVE_B, SERVE_STEPS) or int(toks.min()) < 0 or \
            int(toks.max()) >= lcfg.padded_vocab:
        raise AssertionError(f"generated tokens {tuple(toks.shape)} outside "
                             f"[0, {lcfg.padded_vocab})")
    log(f"[serve] sample: {toks[0, :16].tolist()}")
    for kname, count in s_launches.items():
        report[kname]["launches_by_path"] = {"serve": count}
        report[kname]["launches"] = count
    del params, batch, toks
    torch.cuda.empty_cache()

    # the same weights in float32: decode_step after the served 2,048-token
    # prefill must give the logits of a 2,049-token prefill (the JAX
    # package's consistency check, tests/test_arch_smoke.py, at its 2e-3)
    model32 = build_model(dataclasses.replace(lcfg, dtype="float32"))
    p32 = model32.cast_params(masters)
    t = make_batch(lcfg, 2, SERVE_PROMPT + 1, 0, 1, device=dev)["tokens"]
    with torch.inference_mode():
        _, caches = model32.prefill(p32, {"tokens": t[:, :SERVE_PROMPT]},
                                    cache_len=SERVE_CACHE)
        lg_dec, _ = model32.decode_step(p32, caches, t[:, SERVE_PROMPT:],
                                        SERVE_PROMPT)
        lg_full, _ = model32.prefill(p32, {"tokens": t})
    diff = float((lg_dec - lg_full).abs().max())
    scale = float(lg_full.abs().max())
    if not torch.allclose(lg_dec, lg_full, rtol=CONSISTENCY_TOL,
                          atol=CONSISTENCY_TOL):
        raise AssertionError(f"float32 decode_step differs from prefill by "
                             f"{diff} (tol {CONSISTENCY_TOL})")
    log(f"[serve] float32 full width: decode_step(prefill({SERVE_PROMPT}))"
        f" vs prefill({SERVE_PROMPT + 1}) max abs diff {diff:.3g} over logits up to "
        f"{scale:.3g} (tol {CONSISTENCY_TOL})")
    del masters, p32, caches
    torch.cuda.empty_cache()

    # -- 7. the xLSTM serving path at xlstm-1.3b full width -------------------
    xcfg = get_arch("xlstm-1.3b")
    xmodel = build_model(xcfg)
    n_s = xmodel.kinds.count("s")
    held_gb = torch.cuda.memory_allocated() / 1e9   # by the earlier phases
    t0 = time.perf_counter()
    masters = xmodel.init(torch.Generator(device=dev).manual_seed(0))
    params = xmodel.cast_params(masters)
    torch.cuda.synchronize()
    log(f"[xlstm] {xcfg.name}: {xmodel.param_count(params) / 1e9:.3f} B "
        f"parameters ({xcfg.n_layers} layers: {xmodel.kinds.count('m')} "
        f"mLSTM, {n_s} sLSTM; d_model {xcfg.d_model}, {xcfg.n_heads} heads "
        f"of {xcfg.d_model // xcfg.n_heads}, vocab {xcfg.padded_vocab}), "
        f"{xcfg.dtype}; init + cast {time.perf_counter() - t0:.1f} s")
    batch = make_batch(xcfg, SERVE_B, SERVE_PROMPT, 0, 0)
    batch.pop("labels")
    # a short warm-up through the same entry point, not counted
    generate(xmodel, params, batch, steps=2, cache_len=SERVE_CACHE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    slstm_ops.slstm_scan_launches = 0
    for route in slstm_ops.ROUTES:
        setattr(slstm_ops, f"slstm_{route}_launches", 0)
    stats = {}
    toks = generate(xmodel, params, batch, steps=SERVE_STEPS,
                    cache_len=SERVE_CACHE, stats=stats)
    x_launches = slstm_ops.slstm_scan_launches
    x_routes = {route: getattr(slstm_ops, f"slstm_{route}_launches")
                for route in slstm_ops.ROUTES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[xlstm] generate B={SERVE_B} prompt={SERVE_PROMPT} "
        f"steps={SERVE_STEPS}: prefill {stats['prefill_s']:.4f} s, decode "
        f"{stats['decode_s']:.4f} s = "
        f"{stats['decode_s'] / SERVE_STEPS * 1e3:.3f} ms per step, "
        f"{n_gen / stats['decode_s']:.1f} generated tokens/s in decode, "
        f"{n_gen / (stats['prefill_s'] + stats['decode_s']):.1f} end to "
        f"end; peak memory allocated {peak_gb:.2f} GB ({held_gb:.2f} GB "
        f"of it held by the earlier phases); on {card}")
    log(f"[xlstm] sLSTM kernel launches on the xlstm path: {x_launches} "
        f"({n_s} a prefill + {n_s} x {SERVE_STEPS} decode steps), by route "
        f"{x_routes}")
    want_routes = {"step": n_s * SERVE_STEPS, "cluster": n_s, "coop": 0}
    if x_launches != n_s * (1 + SERVE_STEPS) or x_routes != want_routes:
        raise AssertionError(f"the xlstm path launched the sLSTM kernels "
                             f"{x_launches} times, by route {x_routes}; "
                             f"expected {n_s * (1 + SERVE_STEPS)}, "
                             f"{want_routes}")
    if not stats["logits_finite"]:
        raise AssertionError("xlstm logits are not finite")
    if toks.shape != (SERVE_B, SERVE_STEPS) or int(toks.min()) < 0 or \
            int(toks.max()) >= xcfg.padded_vocab:
        raise AssertionError(f"generated tokens {tuple(toks.shape)} outside "
                             f"[0, {xcfg.padded_vocab})")
    if peak_gb > XL_PEAK_GB:
        raise AssertionError(f"the xlstm path allocated {peak_gb:.2f} GB, "
                             f"more than {XL_PEAK_GB} GB")
    log(f"[xlstm] sample: {toks[0, :16].tolist()}")
    report["slstm_scan"]["launches_by_path"] = {"xlstm": x_launches}
    report["slstm_scan"]["launches"] = x_launches
    for route, n in x_routes.items():
        report["slstm_scan"]["instances"][route]["launches"] = n
    del params, batch, toks
    torch.cuda.empty_cache()

    # the same weights in float32: decode_step after a 256-token prefill
    # must give the logits of a 257-token prefill (2e-3, as above)
    x32 = build_model(dataclasses.replace(xcfg, dtype="float32"))
    p32 = x32.cast_params(masters)
    t = make_batch(xcfg, 2, XL_CHECK_PROMPT + 1, 0, 1, device=dev)["tokens"]
    with torch.inference_mode():
        _, caches = x32.prefill(p32, {"tokens": t[:, :XL_CHECK_PROMPT]})
        lg_dec, _ = x32.decode_step(p32, caches, t[:, XL_CHECK_PROMPT:],
                                    XL_CHECK_PROMPT)
        lg_full, _ = x32.prefill(p32, {"tokens": t})
    diff = float((lg_dec - lg_full).abs().max())
    scale = float(lg_full.abs().max())
    if not bool(torch.isfinite(lg_full).all()) or not torch.allclose(
            lg_dec, lg_full, rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL):
        raise AssertionError(f"xlstm float32 decode_step differs from "
                             f"prefill by {diff} (tol {CONSISTENCY_TOL})")
    log(f"[xlstm] float32 full width: decode_step(prefill("
        f"{XL_CHECK_PROMPT})) vs prefill({XL_CHECK_PROMPT + 1}) max abs diff "
        f"{diff:.3g} over logits up to {scale:.3g} (tol {CONSISTENCY_TOL})")
    del masters, p32, caches
    torch.cuda.empty_cache()

    # -- 8. the multi-tenant query service ----------------------------------
    # phase 3's corpus and config; the service's counts are zeroed inside
    # and read after its close()
    svc_out = service_phase(corpus, cfg, dev, 1000.0, card)
    for step, count in svc_out["grew"].items():
        if count <= 0:
            raise AssertionError(f"service step {step} launched no kernel")
    for kname, count in svc_out["launches"].items():
        if count <= 0:
            raise AssertionError(f"service path never launched {kname}")
        by_path = report[kname].setdefault("launches_by_path", {})
        by_path["service"] = count
        report[kname]["launches"] = sum(by_path.values())
    log(f"[service] {svc_out['queries']} answers in {svc_out['groups']} "
        f"groups (coalesce width mean {svc_out['mean_width']:.2f}, max "
        f"{svc_out['max_width']})")
    log(f"[done] chip_smoke ran {time.perf_counter() - T_START:.0f} s")

    log(card)
    log(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
