"""End-to-end interactive topic-exploration session (the paper's §VI.C
usage scenario, as a script) on the PyTorch/CUDA port.

The same session as ``examples/interactive_analysis.py``, on
``repro_torch``: an analyst (Oliver) explores a geo-tagged review corpus
with a sequence of ad-hoc range queries under different latency/accuracy
preferences (alpha), a union-of-intervals query over two disjoint
districts, a batch of queries optimized together (Alg. 4, with shared
costs reported at the batch level), a node failure recovered by local
retraining, and an elastic repartition — all against one growing model
store.

    PYTHONPATH=src python examples/interactive_analysis_torch.py \\
        [--device cuda|cpu]

It runs on the CUDA card unless ``--device cpu`` is given (every
``"vb"`` fit goes through the E-step kernel) and raises
``DeviceUnavailableError`` when a card is asked for and there is none.
``main`` returns the facts it printed.  The port's Alg. 4 keeps each
query's current plan as an unpruned candidate, so the batch's shared
time is never above the per-query plans' (see the API guide).
"""
import argparse
import time

from repro_torch.api import Interval, MLegoSession, QuerySpec
from repro_torch.configs.lda_default import LDAConfig
from repro_torch.core.lda import log_predictive_probability
from repro_torch.data.corpus import (doc_term_matrix, make_corpus,
                                     train_test_split)
from repro_torch.distributed.elastic import (
    apply_repartition,
    plan_repartition,
    recover_failed,
)
from repro_torch.kernels.common import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = LDAConfig(n_topics=16, vocab_size=600, max_iters=20,
                    e_step_iters=10)
    corpus, _ = make_corpus(2000, cfg.vocab_size, cfg.n_topics,
                            mean_doc_len=40, seed=42)
    train, test = train_test_split(corpus, test_frac=0.1)
    x_test = doc_term_matrix(test)
    session = MLegoSession(train, cfg, kind="vb", device=dev)
    lpp = lambda beta: log_predictive_probability(beta, x_test)  # noqa: E731
    facts = {"device": str(dev), "queries": []}

    print("== session: exploratory range queries ==")
    script = [
        (Interval(0.0, 400.0), 0.0, "first look at district A (speed)"),
        (Interval(300.0, 900.0), 0.0, "pan east"),
        (Interval(0.0, 900.0), 0.5, "zoom out, balanced"),
        (Interval(100.0, 800.0), 0.8, "re-check, accuracy-leaning"),
        (Interval(0.0, 2000.0), 0.0, "whole city, fast"),
    ]
    for q, alpha, label in script:
        t0 = time.perf_counter()
        rep = session.submit(QuerySpec(sigma=q, alpha=alpha))
        dt = time.perf_counter() - t0
        val = lpp(rep.beta)
        print(f"  [{label:34s}] q={q.lo:6.0f}..{q.hi:6.0f} a={alpha}: "
              f"{dt*1e3:7.1f}ms  plan={rep.n_reused} models "
              f"+{rep.n_trained_tokens:6d} tok  lpp={val:.3f}")
        facts["queries"].append({
            "models": list(rep.model_ids), "reused": int(rep.n_reused),
            "trained_tokens": int(rep.n_trained_tokens), "lpp": float(val)})
    print(f"  store: {len(session.store)} models")
    facts["store_models"] = len(session.store)

    print("\n== union predicate: districts A and C, one query ==")
    rep = session.submit(QuerySpec(
        sigma=[Interval(0.0, 400.0), Interval(1400.0, 1800.0)], alpha=0.5))
    val = lpp(rep.beta)
    print(f"  components={len(rep.plans)} merged={rep.n_merged} parts "
          f"+{rep.n_trained_tokens} tok  lpp={val:.3f}")
    facts["predicate"] = {
        "components": len(rep.plans), "merged": int(rep.n_merged),
        "trained_tokens": int(rep.n_trained_tokens), "lpp": float(val)}

    print("\n== batch of three queries (Alg. 4 shared training) ==")
    batch = [Interval(900.0, 1500.0), Interval(1200.0, 1900.0),
             Interval(1000.0, 1700.0)]
    t0 = time.perf_counter()
    br = session.submit_many([QuerySpec(sigma=q) for q in batch])
    dt = time.perf_counter() - t0
    print(f"  {len(br)} queries in {dt*1e3:.1f}ms; "
          f"benefit={br.benefit:.4f} (saved training), "
          f"naive={br.opt.naive_time:.4f} shared={br.opt.total_time:.4f}")
    print(f"  batch costs: search {br.shared_search_s*1e3:.1f}ms + train "
          f"{br.shared_train_s*1e3:.1f}ms shared; per-query merges "
          + " ".join(f"{r.merge_s*1e3:.1f}ms" for r in br))
    facts["batch"] = {
        "queries": len(br), "benefit": float(br.benefit),
        "naive": float(br.opt.naive_time), "shared": float(br.opt.total_time),
        "models": [list(r.model_ids) for r in br]}

    print("\n== node failure: range [400, 800) models lost ==")
    lost = [m for m in session.store.models()
            if Interval(400.0, 800.0).contains(m.o)]
    for m in lost:
        session.store.remove(m.model_id)
    t0 = time.perf_counter()
    fresh = recover_failed(session.store, [Interval(400.0, 800.0)],
                           session.train_range)
    print(f"  retrained {len(fresh)} gap models in "
          f"{time.perf_counter()-t0:.2f}s (only the lost ranges)")
    facts["lost"] = len(lost)
    facts["retrained"] = [[m.o.lo, m.o.hi] for m in fresh]

    print("\n== elastic scale-out: repartition store to 4 workers ==")
    parts = plan_repartition(session.store, Interval(0.0, 2000.0), 4)
    worker_models = apply_repartition(parts, session.store, cfg,
                                      session.train_range)
    facts["workers"] = []
    for w, m in sorted(worker_models.items()):
        print(f"  worker {w}: span {m.o.lo:6.0f}..{m.o.hi:6.0f} "
              f"({m.n_docs} docs merged, lpp covered)")
        facts["workers"].append([int(w), m.o.lo, m.o.hi, int(m.n_docs)])

    print("\nsession complete — every repeat query was answered from the "
          "store at millisecond scale.")
    return facts


if __name__ == "__main__":
    main()
