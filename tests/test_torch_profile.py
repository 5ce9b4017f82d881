"""Kernel profiling hooks of the PyTorch port (``repro_torch.obs.profile``).

``profile=True`` wraps each device launch in a ``record_function`` range
named as the JAX package names its annotations (``mlego.*``) and lands
the single merge's flops and bytes, counted from its shapes, on its
``kernel.launch`` span as ``kernel_*`` attributes — where the JAX package
lands its HLO-derived ``hlo_*`` features (``tests/test_obs.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.api as japi  # noqa: E402
from repro.configs.lda_default import LDAConfig as JaxCfg  # noqa: E402
from repro.data.corpus import make_corpus as jax_make_corpus  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro_torch.configs.lda_default import LDAConfig  # noqa: E402
from repro_torch.data.corpus import make_corpus  # noqa: E402
from repro_torch.obs import profile as obs_profile  # noqa: E402

FIELDS = dict(n_topics=6, vocab_size=150, alpha=0.5, eta=0.05, max_iters=6,
              e_step_iters=5)
CFG = LDAConfig(**FIELDS)
JCFG = JaxCfg(**FIELDS)
K, V = CFG.n_topics, CFG.vocab_size


@pytest.fixture(scope="module")
def corpus():
    c, _ = make_corpus(300, V, K, mean_doc_len=30, seed=3)
    return c


def _events(prof):
    return {e.name for e in prof.events()}


def test_annotate_is_a_record_function_event_on_the_cpu():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with obs_profile.annotate("mlego.test_range", "cpu"):
            torch.ones(8).add_(1.0)
    assert "mlego.test_range" in _events(prof)


def test_launch_features_count_the_kernels_bound():
    n = 8
    merge = obs_profile.merge_features(n, K, V)
    assert merge == {"flops": 3.0 * n * K * V,
                     "hbm_bytes": 4.0 * (n * K * V + n + K * V),
                     "collective_wire_bytes": 0.0}


def _profiled_session(corpus, profile=True):
    sess = tapi.MLegoSession(corpus, CFG, seed=0, backend="device",
                             device="cpu", profile=profile)
    sess.train_range(0.0, 150.0)
    sess.train_range(150.0, 300.0)
    return sess


def test_profile_lands_kernel_features_on_the_merge_launch_span(corpus):
    sess = _profiled_session(corpus)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        rep = sess.submit(tapi.QuerySpec(sigma=tapi.Interval(0.0, 300.0),
                                         alpha=1.0))
    assert "mlego.merge_topics" in _events(prof)
    launches = sess.tracer.spans(trace_id=rep.trace, name="kernel.launch")
    feats = [s for s in launches if "kernel_hbm_bytes" in s.attrs]
    assert feats, "profile=True must land launch features on the span"
    n = len(rep.model_ids)
    assert feats[0].attrs["op"] == "merge_topics"
    assert feats[0].attrs["kernel_hbm_bytes"] == 4.0 * (n * K * V + n + K * V)
    assert feats[0].attrs["kernel_flops"] > 0.0
    assert feats[0].attrs["kernel_collective_wire_bytes"] == 0.0
    assert not any(k.startswith("hlo_") for k in feats[0].attrs)


def test_profile_ranges_cover_the_training_and_ragged_routes(corpus):
    sess = _profiled_session(corpus)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        sess.submit_many([
            tapi.QuerySpec(sigma=tapi.Interval(0.0, 300.0), alpha=1.0),
            tapi.QuerySpec(sigma=tapi.Interval(0.0, 150.0), alpha=1.0)])
        sess.submit(tapi.QuerySpec(sigma=tapi.Interval(20.0, 200.0),
                                   alpha=0.0, materialize="volatile"))
        sess.submit(tapi.QuerySpec(sigma=tapi.Interval(20.0, 200.0),
                                   alpha=0.0, kind="gs",
                                   materialize="volatile"))
    assert {"mlego.merge_topics_ragged", "mlego.vb_estep",
            "mlego.gibbs_sweep"} <= _events(prof)


def test_profile_off_lands_no_features_and_host_ignores_it(corpus):
    sess = _profiled_session(corpus, profile=False)
    rep = sess.submit(tapi.QuerySpec(sigma=tapi.Interval(0.0, 300.0),
                                     alpha=1.0))
    for s in sess.tracer.spans(trace_id=rep.trace, name="kernel.launch"):
        assert not any(k.startswith("kernel_") for k in s.attrs)
    host = tapi.make_backend("host", device="cpu", profile=True)
    assert host.name == "host" and not hasattr(host, "profile")


def test_profiled_answers_equal_the_jax_packages(corpus):
    """Profiling changes no answer: over the same stored models the
    profiled port merges what the profiled JAX session merges (1e-5)."""
    jc, _ = jax_make_corpus(300, V, K, mean_doc_len=30, seed=3)
    np.testing.assert_array_equal(jc.tokens, corpus.tokens)
    port = _profiled_session(corpus)
    jax_sess = japi.MLegoSession(jc, JCFG, seed=0, backend="device",
                                 profile=True)
    for m in sorted(port.store.models(), key=lambda m: m.model_id):
        jax_sess.store.add(japi.Interval(m.o.lo, m.o.hi), m.n_docs,
                           m.n_tokens, m.kind, dict(m.theta))
    rt = port.submit(tapi.QuerySpec(sigma=tapi.Interval(0.0, 300.0),
                                    alpha=1.0))
    rj = jax_sess.submit(japi.QuerySpec(sigma=japi.Interval(0.0, 300.0),
                                        alpha=1.0))
    assert rt.model_ids == rj.model_ids and rj.n_trained_tokens == 0
    np.testing.assert_allclose(rt.beta, rj.beta, rtol=1e-5, atol=1e-5)
