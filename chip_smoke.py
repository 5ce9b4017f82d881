#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MLego once on one GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card.  It
imports only ``repro_torch`` (from ``src/``), never JAX or ``repro``.
Phases, each of which fails the run if anything in it fails:

1. build  — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (first use builds them; the build time is printed);
2. kernels — call every kernel of the query path on the card at the main
   path's shapes and at edge shapes, hold each against its plain PyTorch
   version at the stated tolerance, and time the kernel, the plain
   version and (where one exists) a single PyTorch call computing the
   same function, beside the least time the card could take;
3. main path — at the default ``LDAConfig`` widths (K = 100, V = 8192)
   build 32 window models with ``train_range`` on the ``"device"``
   backend, answer a covered ``submit`` (merge only), a ``submit`` with
   half-window edges (gaps trained by the E-step kernel) and a
   ``submit_many`` of four specs (one ragged launch); every kernel's
   launch count must grow, no report may fall back, β must be finite
   with rows summing to 1, and the covered β must match the ``"host"``
   backend over the same store;
4. routes — a gap query on the ``"host"`` backend and a gap replayed on
   it after an injected device loss must both launch the E-step kernel.

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
# fp32 (non-tensor-core) flop/s — the denominators of every bound below
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

MERGE_TOL = 1e-5
ESTEP_TOL = 2e-4
TRAIN_BUDGET_S = 300.0     # seconds the main path may spend in VB training
N_WINDOWS = 32


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
    from repro_torch.kernels.merge_topics import ops as merge_ops
    from repro_torch.kernels.merge_topics.ref import (
        merge_topics_ref, merge_topics_segments_ref)
    from repro_torch.kernels.vb_estep import ops as estep_ops
    from repro_torch.kernels.vb_estep.ref import vb_estep_ref

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

    def time_ms(fn, reps: int) -> float:
        """Mean device time of one call, L2 flushed before each.

        All calls are queued behind a sleep, so the events bracket the
        kernels and not the host's launch overhead."""
        fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda._sleep(20_000_000)
        for a, b in ev:
            flush.zero_()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in ev) / reps

    def close(got, want, tol) -> float:
        err = (got - want).abs()
        bad = err > tol + tol * want.abs()
        if bool(bad.any()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(
                f"kernel disagrees with its plain version: max abs err "
                f"{float(err.max()):.3g} at tolerance {tol}")
        return float(err.max())

    rng = np.random.default_rng(0)
    report = {}

    # merge_topics
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
            b_ms, b_by = bound_ms(4 * (n * k * v + n + k * v), 3 * n * k * v)
    report["merge_topics"] = dict(
        name="merge_topics", route="cuda",
        source="src/repro_torch/kernels/csrc/merge_topics.cu",
        replaces="src/repro/kernels/merge_topics/merge_topics.py:37",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib)

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

    # vb_estep: x is a real doc-term block of the main path's corpus shape
    errs = []
    t_estep_s = None
    for d, k, v, iters in [(2048, 100, 8192, 20), (135, 6, 150, 20)]:
        corpus_d, beta_true = make_corpus(d, v, k, mean_doc_len=60, seed=1)
        x = torch.tensor(doc_term_matrix(corpus_d), device=dev)
        eeb = torch.tensor(beta_true + 1e-4, dtype=torch.float32, device=dev)
        eeb = (eeb / eeb.sum(1, keepdim=True)).contiguous()
        g0 = torch.ones((d, k), dtype=torch.float32, device=dev)
        g1, s1 = estep_ops.vb_estep(x, eeb, g0, 0.5, iters)
        g2, s2 = vb_estep_ref(x, eeb, g0, 0.5, iters)
        errs.append(max(close(g1, g2, ESTEP_TOL), close(s1, s2, ESTEP_TOL)))
        log(f"[kernels] vb_estep D={d} K={k} V={v} n_iters={iters}: max abs "
            f"err {errs[-1]:.3g} (tol {ESTEP_TOL})")
        if d == 2048:
            nnz = int(torch.count_nonzero(x))
            ms = time_ms(lambda: estep_ops.vb_estep(x, eeb, g0, 0.5, iters), 5)
            plain = time_ms(lambda: vb_estep_ref(x, eeb, g0, 0.5, iters), 5)
            t_estep_s = ms * 1e-3
            # bytes: x, eeb, gamma0 read once; gamma, sstats written once.
            # operations this x needs: phinorm and the gamma product only
            # at nonzero x (4·K flops each, plus the division), the
            # digamma/exp update of every gamma entry (~62 ops), the
            # final multiply by eeb
            n_bytes = 4 * (d * v + k * v + 2 * d * k + k * v)
            n_ops = (iters + 1) * (4 * k * nnz + nnz + 62 * d * k) + k * v
            b_ms, b_by = bound_ms(n_bytes, n_ops)
            log(f"[kernels] vb_estep x has {nnz} nonzeros of {d * v} "
                f"({100.0 * nnz / (d * v):.2f}%); dense work "
                f"{4.0 * d * k * v * (iters + 1):.3g} flops, "
                f"{4.0 * d * k * v * (iters + 1) / (ms * 1e-3) / 1e12:.3f} "
                f"TFLOP/s dense-equivalent")
    report["vb_estep"] = dict(
        name="vb_estep", route="cuda",
        source="src/repro_torch/kernels/csrc/vb_estep.cu",
        replaces="src/repro/kernels/vb_estep/vb_estep.py:76",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
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

    log(card)
    log(json.dumps({"kernels": list(report.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
