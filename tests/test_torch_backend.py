"""``DeviceBackend`` of the PyTorch port: the device LRU's count and
byte bounds, invalidation through the store, warm inserts, and one
ragged launch per batch — the same contract ``tests/test_backend.py``
holds the JAX backend to, run here on CPU tensors (``device="cpu"``)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.api import DeviceBackend, Interval  # noqa: E402
from repro_torch.configs.lda_default import LDAConfig  # noqa: E402
from repro_torch.core.lda import MaterializedModel  # noqa: E402
from repro_torch.core.store import ModelStore  # noqa: E402

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
