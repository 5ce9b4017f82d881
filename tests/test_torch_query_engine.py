"""The last two ``core`` modules of the PyTorch port: the deprecated
``QueryEngine`` alias (``core/query.py``) and the task-vector merge of
parameter trees (``core/delta_merge.py``).

The alias is held as ``tests/test_query_engine.py`` holds the JAX one:
it warns, is-a ``MLegoSession`` and delegates ``execute`` /
``execute_batch`` to ``submit`` / ``submit_many`` (equal bits against a
session with the same seed).  ``merge_param_deltas`` is held to the JAX
package's on the same numpy tree at 1e-6, and keeps each leaf's dtype.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.delta_merge import (  # noqa: E402
    merge_param_deltas as jax_merge_param_deltas)
from repro_torch.api import Interval, MLegoSession, QuerySpec  # noqa: E402
from repro_torch.configs.lda_default import LDAConfig  # noqa: E402
from repro_torch.core.delta_merge import merge_param_deltas  # noqa: E402
from repro_torch.core.store import ModelStore  # noqa: E402
from repro_torch.data.corpus import make_corpus, train_test_split  # noqa: E402

CFG = LDAConfig(n_topics=6, vocab_size=150, alpha=0.5, eta=0.05,
                max_iters=6, e_step_iters=5, gibbs_sweeps=6)


@pytest.fixture(scope="module")
def train():
    corpus, _ = make_corpus(350, CFG.vocab_size, CFG.n_topics,
                            mean_doc_len=40, seed=3)
    return train_test_split(corpus, test_frac=0.15, seed=1)[0]


def test_query_engine_alias_warns_and_delegates(train):
    from repro_torch.core.query import QueryEngine

    with pytest.warns(DeprecationWarning, match="QueryEngine is deprecated"):
        engine = QueryEngine(train, ModelStore(), CFG, kind="vb", seed=0,
                             device="cpu")
    assert isinstance(engine, MLegoSession)
    assert engine.device == torch.device("cpu")
    engine.train_range(0.0, 170.0)
    res = engine.execute(Interval(0.0, 350.0), alpha=0.5)
    ref = MLegoSession(train, CFG, kind="vb", seed=0, device="cpu")
    ref.train_range(0.0, 170.0)
    rep = ref.submit(QuerySpec(sigma=Interval(0.0, 350.0), alpha=0.5))
    np.testing.assert_array_equal(res.beta, rep.beta)
    assert res.n_trained_tokens == rep.n_trained_tokens

    results, opt = engine.execute_batch([Interval(0.0, 200.0)])
    assert len(results) == 1
    assert opt.benefit >= 0.0
    assert engine.last_batch_report is not None
    assert engine.last_batch_report.reports[0] is results[0]


def test_query_engine_needs_a_card_by_default(train):
    from repro_torch.core.query import QueryEngine
    from repro_torch.kernels.common import DeviceUnavailableError
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.warns(DeprecationWarning):
        with pytest.raises(DeviceUnavailableError):
            QueryEngine(train, ModelStore(), CFG)


def _tree(rng):
    return {"w": rng.normal(size=(4, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32),
            "layers": [{"g": rng.normal(size=(3,)).astype(np.float16)},
                       {"g": rng.normal(size=(3,)).astype(np.float16)}]}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def test_delta_merge_matches_the_jax_package():
    rng = np.random.default_rng(0)
    base = _tree(rng)
    tuned = [_map(lambda x, s=s: (x + s).astype(x.dtype), base)
             for s in (1.0, -3.0, 0.5)]
    for weights in (None, [0.25, 0.5, 0.25]):
        got = merge_param_deltas(base, tuned, weights)
        want = jax_merge_param_deltas(base, tuned, weights)
        np.testing.assert_allclose(got["w"], want["w"], rtol=1e-6)
        np.testing.assert_allclose(got["b"], want["b"], rtol=1e-6)
        for g, w in zip(got["layers"], want["layers"]):
            assert g["g"].dtype == np.float16 == np.asarray(w["g"]).dtype
            np.testing.assert_allclose(g["g"], w["g"], rtol=1e-6)


def test_delta_merge_of_tensors_keeps_dtype_and_device():
    """Eq. 6 analogue on tensors: exact for one model, order-independent,
    the weighted average of deltas, each leaf back in its own dtype."""
    rng = np.random.default_rng(1)
    base = {"w": torch.from_numpy(rng.normal(size=(4, 4)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(4,)).astype(np.float32))
            .to(torch.bfloat16)}
    t1 = {k: v + 1.0 for k, v in base.items()}
    t2 = {k: v - 3.0 for k, v in base.items()}
    out1 = merge_param_deltas(base, [t1], [1.0])
    torch.testing.assert_close(out1["w"], t1["w"], rtol=1e-6, atol=1e-6)
    a = merge_param_deltas(base, [t1, t2], [0.25, 0.75])
    b = merge_param_deltas(base, [t2, t1], [0.75, 0.25])
    torch.testing.assert_close(a["w"], b["w"], rtol=1e-6, atol=1e-6)
    assert a["b"].dtype == torch.bfloat16 and a["w"].device == base["w"].device
    want_b = (base["b"].float() + 0.25 - 2.25).to(torch.bfloat16)
    torch.testing.assert_close(a["b"], want_b)
    with pytest.raises(ValueError, match="nothing to merge"):
        merge_param_deltas(base, [])
    with pytest.raises(ValueError, match="length mismatch"):
        merge_param_deltas(base, [t1], [0.5, 0.5])
