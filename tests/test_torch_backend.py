"""``DeviceBackend`` of the PyTorch port: the device LRU's count and
byte bounds, invalidation through the store, warm inserts, one ragged
launch per batch, and the ``"gs"`` gap-training route — the same
contract ``tests/test_backend.py`` and ``tests/test_gibbs_blocked.py``
hold the JAX backend to, run here on CPU tensors (``device="cpu"``)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.api import (  # noqa: E402
    DeviceBackend,
    Interval,
    MLegoSession,
    QuerySpec,
)
from repro_torch.configs.lda_default import LDAConfig  # noqa: E402
from repro_torch.core.lda import (  # noqa: E402
    MaterializedModel,
    log_predictive_probability,
)
from repro_torch.core.store import ModelStore  # noqa: E402
from repro_torch.data.corpus import (  # noqa: E402
    doc_term_matrix,
    make_corpus,
    train_test_split,
)

CFG = LDAConfig(n_topics=4, vocab_size=64, eta=0.05)
RNG = np.random.default_rng(7)
ENTRY_BYTES = 4 * 64 * 4                       # one (4, 64) f32 statistic


def _model(mid, k=4, v=64):
    return MaterializedModel(mid, Interval(float(mid), float(mid + 1)),
                             10, 100, "vb",
                             {"lam": RNG.gamma(1.0, 1.0, (k, v))
                              .astype(np.float32)})


def _backend(**kw):
    return DeviceBackend(device="cpu", **kw)


def test_cache_respects_capacity_with_lru_order():
    backend = _backend(capacity=2)
    models = [_model(i) for i in range(3)]
    backend.merge(models, "vb", CFG)
    assert len(backend.cache) == 2
    assert backend.stats.cache_evictions == 1
    assert 0 not in backend.cache
    assert 1 in backend.cache and 2 in backend.cache
    before = backend.stats
    backend.merge(models[1:], "vb", CFG)
    d = backend.stats.delta(before)
    assert d.cache_hits == 2 and d.cache_misses == 0


def test_cache_byte_bound_evicts_lru():
    backend = _backend(capacity=64, max_bytes=2 * ENTRY_BYTES)
    backend.merge([_model(i) for i in range(3)], "vb", CFG)
    assert len(backend.cache) == 2 and 0 not in backend.cache
    assert backend.cache.resident_bytes == 2 * ENTRY_BYTES
    assert backend.stats.cache_resident_bytes == 2 * ENTRY_BYTES


def test_oversized_model_passes_through_without_evicting():
    backend = _backend(capacity=64, max_bytes=3 * ENTRY_BYTES)
    backend.merge([_model(0), _model(1)], "vb", CFG)
    big = _model(9, k=16, v=256)                  # 4x the whole budget
    epoch = backend.cache.epoch
    backend.cache.get(big, "lam")
    assert 9 not in backend.cache and len(backend.cache) == 2
    assert backend.cache.put(big, "lam") is False
    assert backend.cache.resident_bytes == 2 * ENTRY_BYTES
    assert backend.cache.epoch == epoch


def test_store_remove_invalidates_and_warm_insert_hits():
    backend = _backend(capacity=8)
    store = ModelStore()
    backend.bind_store(store)
    ms = [store.add(Interval(float(i), float(i + 1)), 10, 100, "vb",
                    _model(i).theta) for i in range(3)]
    backend.merge(ms, "vb", CFG)
    assert backend.cache.resident_bytes == 3 * ENTRY_BYTES
    store.remove(ms[1].model_id)
    assert ms[1].model_id not in backend.cache
    assert backend.stats.cache_invalidations == 1
    fresh = store.add(Interval(5.0, 6.0), 10, 100, "vb", _model(5).theta)
    backend.note_trained(fresh)
    assert backend.stats.train_uploads == 1
    before = backend.stats
    backend.merge([fresh], "vb", CFG)
    assert backend.stats.delta(before).cache_hits == 1
    backend.bind_store(ModelStore())
    assert len(backend.cache) == 0


def test_volatile_models_bypass_the_cache():
    backend = _backend(capacity=8)
    backend.merge([_model(-1)], "vb", CFG)
    assert len(backend.cache) == 0 and backend.stats.cache_misses == 1


def test_cache_rejects_bad_bounds():
    with pytest.raises(ValueError, match="max_bytes"):
        _backend(max_bytes=0)
    with pytest.raises(ValueError, match="capacity"):
        _backend(capacity=0)


def test_merge_many_is_one_launch_with_zero_pad_rows():
    backend = _backend(capacity=16)
    models = [_model(i) for i in range(5)]
    lists = [models[:4], models[4:], models[1:3]]
    out = backend.merge_many(lists, "vb", CFG)
    assert backend.stats.device_launches == 1 and backend.stats.pad_rows == 0
    for parts, beta in zip(lists, out):
        np.testing.assert_allclose(
            beta, backend.merge(parts, "vb", CFG), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(beta.sum(1), 1.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# the "gs" route: the cases of tests/test_gibbs_blocked.py:155-219
# ---------------------------------------------------------------------------

GS_CFG = LDAConfig(n_topics=8, vocab_size=300, alpha=0.5, eta=0.05,
                   gibbs_sweeps=10)


@pytest.fixture(scope="module")
def gs_split():
    c, _ = make_corpus(240, GS_CFG.vocab_size, GS_CFG.n_topics,
                       mean_doc_len=40, seed=0)
    return train_test_split(c, test_frac=0.15, seed=1)


def _gs_session(train, backend="device", **kw):
    return MLegoSession(train, GS_CFG, kind="gs", backend=backend, seed=0,
                        device="cpu", **kw)


def test_device_train_gap_parity_for_gs(gs_split):
    """Uncovered gs query: host trains the exact scan, device the
    blocked route — answers agree statistically and both are proper
    topic matrices."""
    train, test = gs_split
    x_test = doc_term_matrix(test)
    host, dev = _gs_session(train, "host"), _gs_session(train)
    spec = QuerySpec(sigma=Interval(0.0, 150.0))
    rh, rd = host.submit(spec), dev.submit(spec)
    for r in (rh, rd):
        assert r.n_trained_tokens > 0
        assert np.isfinite(r.beta).all()
        np.testing.assert_allclose(r.beta.sum(1), 1.0, rtol=1e-4)
    lpp_h = log_predictive_probability(rh.beta, x_test)
    lpp_d = log_predictive_probability(rd.beta, x_test)
    assert abs(lpp_h - lpp_d) < 0.3
    assert rh.train_device_ms == 0.0, "host path must not claim kernel time"
    assert rd.train_device_ms > 0.0
    assert rd.backend == "device" and rh.backend == "host"
    assert dev.backend.stats.gap_device_trains == 1


def test_device_gap_model_warms_the_lru(gs_split):
    train, _ = gs_split
    dev = _gs_session(train)
    rep = dev.submit(QuerySpec(sigma=Interval(0.0, 150.0)))
    assert len(rep.materialized) == 1
    mid = rep.materialized[0].model_id
    assert mid in dev.backend.cache, \
        "fresh gap model must be warm-inserted into the device cache"
    assert dev.backend.stats.train_uploads == 1
    # and the merge that followed read it back as a hit, not a re-upload
    assert dev.backend.stats.cache_hits >= 1


def test_volatile_gap_model_does_not_warm_the_lru(gs_split):
    train, _ = gs_split
    dev = _gs_session(train)
    rep = dev.submit(QuerySpec(sigma=Interval(0.0, 150.0),
                               materialize="volatile"))
    assert [m.model_id for m in rep.materialized] == [-1]
    assert dev.backend.stats.train_uploads == 0
    assert len(dev.backend.cache) == 0


def test_train_timings_feed_backend_keyed_kappa(gs_split):
    """A calibrated session observes device gap training under the
    device key, so the planner prices device training separately."""
    train, _ = gs_split
    dev = _gs_session(train, cost="calibrated")
    dev.submit(QuerySpec(sigma=Interval(0.0, 150.0)))
    cal = dev.cost.calibration
    assert "device" in cal.train_obs and cal.train_obs["device"]
    assert "host" not in cal.train_obs


def test_gs_gaps_train_against_the_stores_dsgs_prior(gs_split, monkeypatch):
    """The device route hands the blocked sampler the store's summed
    ΔN_kv as its global prior once the store holds gs models."""
    from repro_torch.core import gibbs
    seen = []
    real = gibbs.cgs_fit_blocked

    def spy(*a, **kw):
        seen.append(kw.get("global_nkv"))
        assert kw.get("block_docs") == 16
        return real(*a, **kw)
    monkeypatch.setattr(gibbs, "cgs_fit_blocked", spy)
    train, _ = gs_split
    backend = DeviceBackend(device="cpu", gibbs_block_docs=16)
    s = MLegoSession(train, GS_CFG, kind="gibbs", backend=backend,
                     device="cpu")
    first = s.train_range(0.0, 60.0)
    s.submit(QuerySpec(sigma=Interval(0.0, 120.0)))
    assert seen[0] is None
    np.testing.assert_array_equal(seen[1], first.theta["delta_nkv"])
    assert backend.kernel_route("gs") and backend.stats.gap_device_trains == 2


def test_vb_route_builds_the_csr_from_the_tokens():
    """The device route uploads a gap's tokens and builds its CSR there,
    never the dense matrix; λ is the dense route's to the bit."""
    from repro_torch.core.vb import vb_fit
    cfg = LDAConfig(n_topics=5, vocab_size=90, max_iters=5, e_step_iters=4)
    corpus, _ = make_corpus(200, 90, 5, mean_doc_len=25, seed=11)
    gap = corpus.subset(corpus.attr[30], corpus.attr[170])
    got = DeviceBackend(device="cpu")._train_vb_kernel(
        gap, cfg, torch.Generator().manual_seed(4))["lam"]
    want = vb_fit(doc_term_matrix(gap), torch.Generator().manual_seed(4),
                  cfg, use_kernel=True).numpy()
    assert got.shape == (5, 90) and np.array_equal(got, want)


def test_gs_route_refuses_a_bad_block_size():
    with pytest.raises(ValueError, match="gibbs_block_docs"):
        DeviceBackend(device="cpu", gibbs_block_docs=0)
    backend = DeviceBackend(device="cpu")
    assert backend.trainer("gs") == backend._train_gs_kernel
    assert backend.trainer("vb") == backend._train_vb_kernel
