"""Quickstart on the PyTorch/CUDA port: one session, typed queries,
growing reuse capital.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]

The same walk through MLego as ``examples/quickstart.py``, on
``repro_torch.api``:

  1. Open an ``MLegoSession`` over a corpus — the session owns the
     dataset D, the model store, the cost model, and the RNG stream
     from the paper's Def. 1 query tuple q = {F, alpha, D, sigma, M}.
  2. Materialize LDA models for two time windows (offline capital).
  3. Submit a typed ``QuerySpec`` and get a ``QueryReport`` back: the
     query spanning both windows is answered *without retraining*.
  4. Submit a narrower query that is only partially covered: the
     planner reuses what it can, trains just the gap, and materializes
     the fresh model so the *next* query is faster.
  5. A union-of-intervals predicate is a single query.

The session runs on the CUDA card (``--device``, ``cuda`` by default;
``cpu`` runs the kernels' plain versions): every ``"vb"`` fit goes
through the E-step kernel.  Asking for ``cuda`` without a card raises
``DeviceUnavailableError``.  ``main`` returns the facts it printed.  See
src/repro_torch/api/README.md for the API.
"""
import argparse

import numpy as np

from repro_torch.api import Interval, MLegoSession, QuerySpec
from repro_torch.configs.lda_default import LDAConfig
from repro_torch.core.lda import log_predictive_probability
from repro_torch.data.corpus import (doc_term_matrix, make_corpus,
                                     train_test_split)
from repro_torch.kernels.common import resolve_device


def _query(rep, lpp: float) -> dict:
    return {"models": list(rep.model_ids),
            "trained_tokens": int(rep.n_trained_tokens),
            "merged": int(rep.n_merged), "components": len(rep.plans),
            "lpp": float(lpp)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = LDAConfig(n_topics=12, vocab_size=400, max_iters=25,
                    e_step_iters=10)
    corpus, _ = make_corpus(1000, cfg.vocab_size, cfg.n_topics,
                            mean_doc_len=40, seed=0)
    train, test = train_test_split(corpus, test_frac=0.1)
    x_test = doc_term_matrix(test)

    session = MLegoSession(train, cfg, kind="vb", device=dev)
    facts = {"device": str(dev)}

    print("== materializing models for two time windows ==")
    m1 = session.train_range(0.0, 500.0)
    m2 = session.train_range(500.0, 1000.0)
    print(f"  m1: {m1.o} ({m1.n_docs} docs)   m2: {m2.o} ({m2.n_docs} docs)")
    facts["windows"] = [[m.o.lo, m.o.hi, int(m.n_docs)] for m in (m1, m2)]

    print("\n== analytic query over the union (alpha=0.5) ==")
    rep = session.submit(QuerySpec(sigma=Interval(0.0, 1000.0), alpha=0.5))
    lpp = log_predictive_probability(rep.beta, x_test)
    print(f"  plan: models {rep.model_ids}, "
          f"trained {rep.n_trained_tokens} tokens, "
          f"search {rep.search_s*1e3:.1f}ms, merge {rep.merge_s*1e3:.1f}ms")
    print(f"  held-out lpp: {lpp:.4f}")
    facts["union"] = _query(rep, lpp)

    print("\n== top words per topic (first 3 topics) ==")
    for k in range(3):
        top = np.argsort(-rep.beta[k])[:8]
        print(f"  topic {k}: words {top.tolist()}")

    print("\n== a narrower ad-hoc query (partial coverage) ==")
    rep2 = session.submit(QuerySpec(sigma=Interval(250.0, 750.0), alpha=0.2))
    lpp2 = log_predictive_probability(rep2.beta, x_test)
    print(f"  plan: {rep2.model_ids} + {rep2.n_trained_tokens} "
          f"fresh tokens -> lpp {lpp2:.4f}")
    print(f"  store now holds {len(session.store)} models "
          f"({session.store.nbytes()/1e6:.1f} MB) — reuse capital grows")
    facts["narrow"] = _query(rep2, lpp2)
    facts["store"] = {"models": len(session.store),
                      "bytes": int(session.store.nbytes())}

    print("\n== union predicate: two disjoint windows, one query ==")
    rep3 = session.submit(QuerySpec(
        sigma=[Interval(0.0, 250.0), Interval(750.0, 1000.0)], alpha=0.5))
    lpp3 = log_predictive_probability(rep3.beta, x_test)
    print(f"  components: {len(rep3.plans)}, merged {rep3.n_merged} parts, "
          f"lpp {lpp3:.4f}")
    facts["predicate"] = _query(rep3, lpp3)
    return facts


if __name__ == "__main__":
    main()
