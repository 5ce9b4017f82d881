"""Elastic repartition and failure recovery of the PyTorch port.

The four tests of ``tests/test_elastic.py`` and the ``recover_quarantined``
tests of ``tests/test_faults.py``, run on the port's store, plus the
repartition of one set of numpy models by both packages (the same
partitions, merged λ at 1e-5) and a recovery whose ``train_fn`` is a
port session's ``train_range`` on the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs.lda_default import LDAConfig as JaxCfg  # noqa: E402
from repro.core.plans import Interval as JaxInterval  # noqa: E402
from repro.core.store import ModelStore as JaxStore  # noqa: E402
from repro.distributed import elastic as jax_elastic  # noqa: E402
from repro_torch.api import MLegoSession  # noqa: E402
from repro_torch.configs.lda_default import LDAConfig  # noqa: E402
from repro_torch.core.lda import MaterializedModel  # noqa: E402
from repro_torch.core.merge import merge_vb  # noqa: E402
from repro_torch.core.plans import Interval  # noqa: E402
from repro_torch.core.store import ModelStore  # noqa: E402
from repro_torch.data.corpus import make_corpus  # noqa: E402
from repro_torch.distributed.elastic import (  # noqa: E402
    apply_repartition,
    partition_ranges,
    plan_repartition,
    recover_failed,
    recover_quarantined,
)

CFG = LDAConfig(n_topics=4, vocab_size=32, eta=0.05)


def _store(rng, ranges):
    store = ModelStore()
    for lo, hi in ranges:
        store.add(Interval(lo, hi), 10, 100, "vb",
                  {"lam": rng.gamma(1.0, 1.0, (4, 32)).astype(np.float32)})
    return store


def _filled_store():
    store = ModelStore()
    rng = np.random.default_rng(0)
    for lo in (0.0, 10.0, 20.0):
        store.add(Interval(lo, lo + 10.0), 10, 100, "vb",
                  {"lam": rng.random((4, 32)).astype(np.float32)})
    return store


def test_partition_ranges_tile_universe():
    spans = partition_ranges(Interval(0.0, 100.0), 4)
    assert len(spans) == 4
    assert spans[0].lo == 0.0 and spans[-1].hi == 100.0
    for a, b in zip(spans, spans[1:]):
        assert a.hi == b.lo


def test_repartition_covers_everything():
    rng = np.random.default_rng(0)
    store = _store(rng, [(0, 20), (20, 45), (50, 75), (80, 100)])
    parts = plan_repartition(store, Interval(0.0, 100.0), 2)
    for part in parts:
        covered = [store.get(m).o for m in part.model_ids]
        total = sum(iv.length for iv in covered) + \
            sum(g.length for g in part.missing)
        assert total == pytest.approx(part.span.length)


def test_apply_repartition_merges_exactly():
    rng = np.random.default_rng(1)
    store = _store(rng, [(0, 25), (25, 50), (50, 75), (75, 100)])
    parts = plan_repartition(store, Interval(0.0, 100.0), 2)
    trained = []

    def train_fn(lo, hi):
        trained.append((lo, hi))
        return MaterializedModel(1000 + len(trained), Interval(lo, hi), 5,
                                 50, "vb",
                                 {"lam": np.ones((4, 32), np.float32)})

    out = apply_repartition(parts, store, CFG, train_fn)
    assert not trained, "fully covered universe must not retrain"
    assert set(out) == {0, 1}
    w0_models = [store.get(mid) for mid in parts[0].model_ids]
    np.testing.assert_allclose(out[0].theta["lam"],
                               merge_vb(w0_models, CFG), rtol=1e-6)


def test_recover_failed_trains_only_lost():
    rng = np.random.default_rng(2)
    store = _store(rng, [(0, 30), (60, 100)])
    trained = []

    def train_fn(lo, hi):
        trained.append((lo, hi))
        return MaterializedModel(-1, Interval(lo, hi), 1, 10, "vb",
                                 {"lam": np.ones((4, 32), np.float32)})

    fresh = recover_failed(store, [Interval(0.0, 100.0)], train_fn)
    assert trained == [(30.0, 60.0)]
    assert len(fresh) == 1


def test_runtime_quarantine_and_elastic_recovery():
    store = _filled_store()
    store.quarantine(1, reason="device loss mid-read")
    assert {m.model_id for m in store.models()} == {0, 2}
    assert store.quarantined[0].o == Interval(10.0, 20.0)

    trained = []

    def train_fn(lo, hi):
        trained.append((lo, hi))
        rng = np.random.default_rng(99)
        return store.add(Interval(lo, hi), 10, 100, "vb",
                         {"lam": rng.random((4, 32)).astype(np.float32)})

    fresh = recover_quarantined(store, train_fn)
    assert trained == [(10.0, 20.0)]        # exactly the hole, nothing else
    assert len(fresh) == 1
    assert store.quarantined == []          # ledger drained (clear=True)
    assert len(store) == 3

    # already-covered holes are not retrained (local recovery only)
    store.quarantine(fresh[0].model_id, reason="again")
    store.add(Interval(10.0, 20.0), 10, 100, "vb",
              {"lam": np.zeros((4, 32), np.float32)})
    trained.clear()
    recover_quarantined(store, train_fn)
    assert trained == []


def test_recover_quarantined_can_keep_ledger():
    store = _filled_store()
    store.quarantine(0)
    recover_quarantined(store, lambda lo, hi: None, clear=False)
    assert len(store.quarantined) == 1


@pytest.mark.parametrize("n_workers", [1, 2, 3, 4])
def test_repartition_matches_the_jax_package(n_workers):
    """One set of numpy models in both packages' stores: the same
    partitions, the same retrain set, and merged λ at 1e-5."""
    rng = np.random.default_rng(4)
    ranges = [(0, 20), (20, 45), (50, 75), (75, 90), (10, 30)]
    lams = [rng.gamma(1.0, 1.0, (4, 32)).astype(np.float32) for _ in ranges]
    store, jstore = ModelStore(), JaxStore()
    for (lo, hi), lam in zip(ranges, lams):
        store.add(Interval(lo, hi), 10, 100, "vb", {"lam": lam})
        jstore.add(JaxInterval(lo, hi), 10, 100, "vb", {"lam": lam})
    gap = np.random.default_rng(5).gamma(1.0, 1.0, (4, 32)).astype(
        np.float32)

    def train_fn(lo, hi):
        return MaterializedModel(-1, Interval(lo, hi), 3, 30, "vb",
                                 {"lam": gap})

    parts = plan_repartition(store, Interval(0.0, 100.0), n_workers)
    jparts = jax_elastic.plan_repartition(jstore, JaxInterval(0.0, 100.0),
                                          n_workers)
    assert [(p.model_ids, [(g.lo, g.hi) for g in p.missing])
            for p in parts] == \
        [(p.model_ids, [(g.lo, g.hi) for g in p.missing]) for p in jparts]
    out = apply_repartition(parts, store, CFG, train_fn)
    jout = jax_elastic.apply_repartition(
        jparts, jstore, JaxCfg(n_topics=4, vocab_size=32, eta=0.05),
        lambda lo, hi: train_fn(lo, hi))
    assert set(out) == set(jout)
    for w in out:
        assert out[w].n_docs == jout[w].n_docs
        np.testing.assert_allclose(out[w].theta["lam"],
                                   jout[w].theta["lam"], rtol=1e-5,
                                   atol=1e-5)


def test_quarantined_window_is_retrained_by_a_session():
    """``train_fn`` is a port session's ``train_range``: the quarantined
    window comes back as a fresh, persisted model and the ledger empties."""
    cfg = LDAConfig(n_topics=4, vocab_size=60, max_iters=3, e_step_iters=3)
    corpus, _ = make_corpus(200, 60, 4, mean_doc_len=15, seed=1)
    session = MLegoSession(corpus, cfg, device="cpu",
                           backend="device_sharded")
    for lo in (0.0, 100.0):
        session.train_range(lo, lo + 100.0)
    lost = session.store.models()[1]
    session.store.quarantine(lost.model_id, reason="device loss")
    fresh = recover_quarantined(session.store, session.train_range)
    assert [m.o for m in fresh] == [Interval(100.0, 200.0)]
    assert session.store.quarantined == []
    assert {m.o for m in session.store.models()} == \
        {Interval(0.0, 100.0), Interval(100.0, 200.0)}
    assert np.isfinite(fresh[0].theta["lam"]).all()
