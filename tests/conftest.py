"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches
must see the single real CPU device; multi-device tests run in
subprocesses (tests/test_multidevice.py)."""
import numpy as np
import pytest

from repro.configs.lda_default import LDAConfig
from repro.core.cost import CostModel
from repro.core.plans import Interval
from repro.core.store import ModelStore
from repro.data.corpus import DataIndex, make_corpus


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture(scope="session")
def small_cfg():
    return LDAConfig(n_topics=8, vocab_size=200, alpha=0.5, eta=0.05,
                     max_iters=15, e_step_iters=8, gibbs_sweeps=10)


@pytest.fixture(scope="session")
def small_corpus(small_cfg):
    corpus, beta = make_corpus(400, small_cfg.vocab_size,
                               small_cfg.n_topics, mean_doc_len=30, seed=7)
    return corpus, beta


@pytest.fixture(scope="session")
def small_index(small_corpus):
    return DataIndex(small_corpus[0])


def build_store(index, n_models=10, seed=0, span=(0.0, 400.0), k=8, v=200,
                kind="vb"):
    """Random store of materialized stand-in models (stats are dummies —
    plan-search tests only use ranges and counts)."""
    rng = np.random.default_rng(seed)
    store = ModelStore()
    for _ in range(n_models):
        lo = rng.uniform(span[0], span[1] * 0.8)
        hi = lo + rng.uniform((span[1] - span[0]) * 0.02,
                              (span[1] - span[0]) * 0.3)
        nd, nt = index.count(lo, hi)
        theta = ({"lam": np.ones((k, v), np.float32)} if kind == "vb"
                 else {"delta_nkv": np.ones((k, v), np.float32)})
        store.add(Interval(lo, hi), nd, nt, kind, theta)
    return store


@pytest.fixture()
def cost_model():
    return CostModel(max_iters=15, n_topics=8)
