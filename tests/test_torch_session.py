"""The query path of the PyTorch port against the JAX package, over one
on-disk store that both packages load.

* planning is deterministic, so the same ``QuerySpec`` sequence gives
  equal Plan IR in both packages (analytic cost model);
* on plans without a gap both packages only merge, so β agrees at 1e-5;
* on plans with gaps the trainers draw different random numbers, so the
  port's held-out log predictive probability is held to the spread of
  two JAX seeds;
* the port's ``"host"`` and ``"device"`` backends (the latter on CPU
  tensors, through each kernel's plain version) agree at 1e-5;
* a missing card or a failing kernel raises — nothing degrades quietly.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.api as japi  # noqa: E402
from repro.configs.lda_default import LDAConfig as JaxCfg  # noqa: E402
from repro.core.lda import log_predictive_probability  # noqa: E402
from repro.core.store import ModelStore as JaxStore  # noqa: E402
from repro.data.corpus import doc_term_matrix  # noqa: E402
from repro.data.corpus import make_corpus as jax_make_corpus  # noqa: E402
from repro.data.corpus import train_test_split as jax_split  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro_torch.api import backend as tbackend  # noqa: E402
from repro_torch.configs.lda_default import LDAConfig  # noqa: E402
from repro_torch.core.store import ModelStore  # noqa: E402
from repro_torch.data.corpus import make_corpus, train_test_split  # noqa: E402
from repro_torch.kernels.common import (DeviceUnavailableError,  # noqa: E402
                                        KernelError)

FIELDS = dict(n_topics=6, vocab_size=150, alpha=0.5, eta=0.05, max_iters=6,
              e_step_iters=5)
CFG = LDAConfig(**FIELDS)
JCFG = JaxCfg(**FIELDS)
EDGES = (0.0, 100.0, 200.0, 300.0)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def corpora():
    jc, _ = jax_make_corpus(300, 150, 6, mean_doc_len=30, seed=3)
    tc, _ = make_corpus(300, 150, 6, mean_doc_len=30, seed=3)
    np.testing.assert_array_equal(jc.tokens, tc.tokens)
    return jax_split(jc, test_frac=0.1, seed=1), \
        train_test_split(tc, test_frac=0.1, seed=1)


@pytest.fixture(scope="module")
def store_dir(tmp_path_factory):
    """Synthetic mergeable Θ tiling EDGES, saved once by the JAX package."""
    rng = np.random.default_rng(7)
    store = JaxStore()
    for lo, hi in zip(EDGES, EDGES[1:]):
        theta = {"lam": rng.gamma(1.0, 1.0, (6, 150)).astype(np.float32)}
        store.add(japi.Interval(lo, hi), 50, 500, "vb", theta)
    path = tmp_path_factory.mktemp("shared_store")
    store.save(str(path))
    return str(path)


def _jax(corpora, store_dir, backend="host", seed=0):
    return japi.MLegoSession(corpora[0][0], JCFG,
                             store=JaxStore.load(store_dir),
                             backend=backend, seed=seed)


def _port(corpora, store_dir, backend="host", seed=0, store=None):
    return tapi.MLegoSession(corpora[1][0], CFG,
                             store=store or ModelStore.load(store_dir),
                             backend=backend, seed=seed, device="cpu")


def _ir(plan):
    steps = []
    for s in plan.steps:
        name = type(s).__name__
        if name == "FetchStep":
            steps.append((name, s.model_id, s.o.lo, s.o.hi, s.n_tokens))
        elif name == "TrainGapStep":
            steps.append((name, s.gap.lo, s.gap.hi, s.n_tokens))
        else:
            steps.append((name, s.n_parts))
    return (plan.sigma.lo, plan.sigma.hi, tuple(steps))


SPECS = [  # (sigma, alpha, materialize)
    ([(0.0, 300.0)], 1.0, "persist"),
    ([(50.0, 250.0)], 0.0, "volatile"),
    ([(0.0, 100.0), (200.0, 300.0)], 0.5, "persist"),
    ([(120.0, 180.0)], 0.0, "persist"),
    ([(100.0, 200.0)], 0.0, "persist"),
]


def _spec(api, sigma, alpha, materialize):
    return api.QuerySpec(sigma=[api.Interval(lo, hi) for lo, hi in sigma],
                         alpha=alpha, materialize=materialize)


def test_same_specs_give_equal_plan_ir(corpora, store_dir):
    js, ts = _jax(corpora, store_dir), _port(corpora, store_dir)
    for sigma, alpha, mat in SPECS:
        rj = js.submit(_spec(japi, sigma, alpha, mat))
        rt = ts.submit(_spec(tapi, sigma, alpha, mat))
        assert [_ir(p.ir) for p in rt.plans] == [_ir(p.ir) for p in rj.plans]
        assert rt.n_trained_tokens == rj.n_trained_tokens
    assert sorted((m.model_id, m.o.lo, m.o.hi) for m in ts.store.models()) \
        == sorted((m.model_id, m.o.lo, m.o.hi) for m in js.store.models())


def test_same_batch_gives_equal_plan_ir(corpora, store_dir):
    specs = [(s, 0.0, "volatile") for s, _, _ in SPECS]
    bj = _jax(corpora, store_dir).submit_many(
        [_spec(japi, *s) for s in specs])
    bt = _port(corpora, store_dir).submit_many(
        [_spec(tapi, *s) for s in specs])
    assert [[_ir(p.ir) for p in r.plans] for r in bt] == \
        [[_ir(p.ir) for p in r.plans] for r in bj]


@pytest.mark.parametrize("backend", ["host", "device"])
def test_gap_free_beta_matches_jax(corpora, store_dir, backend):
    js = _jax(corpora, store_dir, backend=backend)
    ts = _port(corpora, store_dir, backend=backend)
    for sigma in ([(0.0, 300.0)], [(0.0, 100.0), (200.0, 300.0)],
                  [(100.0, 300.0)]):
        rj = js.submit(_spec(japi, sigma, 1.0, "persist"))
        rt = ts.submit(_spec(tapi, sigma, 1.0, "persist"))
        assert rj.n_trained_tokens == rt.n_trained_tokens == 0
        assert rt.model_ids == rj.model_ids
        np.testing.assert_allclose(rt.beta, rj.beta, **TOL)
    specs = [[(0.0, 300.0)], [(100.0, 300.0)], [(0.0, 200.0)]]
    bj = js.submit_many([_spec(japi, s, 0.0, "persist") for s in specs])
    bt = ts.submit_many([_spec(tapi, s, 0.0, "persist") for s in specs])
    for rj, rt in zip(bj, bt):
        np.testing.assert_allclose(rt.beta, rj.beta, **TOL)


def test_gap_beta_within_jax_seed_spread(corpora, store_dir):
    """A plan with gaps: the port's held-out lpp, averaged over two
    seeds, lies within the spread of two JAX seeds (widened by that
    spread on each side).  The trainers draw different random numbers,
    and one seed alone can sit outside two other seeds' spread, so the
    port side is averaged."""
    spec = [(50.0, 250.0)]
    x_test = doc_term_matrix(corpora[0][1])
    lpp_j = [log_predictive_probability(
        _jax(corpora, store_dir, "device", seed).submit(
            _spec(japi, spec, 0.0, "volatile")).beta, x_test)
        for seed in (0, 1)]
    lpp_t = []
    for seed in (0, 1):
        rep = _port(corpora, store_dir, "device", seed=seed).submit(
            _spec(tapi, spec, 0.0, "volatile"))
        assert rep.n_trained_tokens > 0
        lpp_t.append(log_predictive_probability(rep.beta, x_test))
    spread = abs(lpp_j[0] - lpp_j[1])
    assert min(lpp_j) - spread <= np.mean(lpp_t) <= max(lpp_j) + spread, \
        (lpp_t, lpp_j)


def test_port_host_and_device_agree(corpora, store_dir):
    host = _port(corpora, store_dir, "host")
    dev = _port(corpora, store_dir, "device", store=host.store)
    for sigma in ([(0.0, 300.0)], [(0.0, 100.0), (200.0, 300.0)]):
        rh = host.submit(_spec(tapi, sigma, 1.0, "persist"))
        rd = dev.submit(_spec(tapi, sigma, 1.0, "persist"))
        assert (rh.backend, rd.backend) == ("host", "device")
        np.testing.assert_allclose(rh.beta, rd.beta, **TOL)
        assert rd.merge_device_ms > 0.0
    specs = [[(0.0, 300.0)], [(100.0, 300.0)], [(0.0, 200.0)],
             [(200.0, 300.0)]]
    bh = host.submit_many([_spec(tapi, s, 0.0, "persist") for s in specs])
    bd = dev.submit_many([_spec(tapi, s, 0.0, "persist") for s in specs])
    assert bd.pad_rows == 0 and bd.backend == "device"
    for rh, rd in zip(bh, bd):
        np.testing.assert_allclose(rh.beta, rd.beta, **TOL)


def test_device_backend_trains_gaps_through_the_kernel_route(corpora):
    s = tapi.MLegoSession(corpora[1][0], CFG, backend="device",
                          device="cpu")
    rep = s.submit(tapi.QuerySpec(sigma=tapi.Interval(0.0, 150.0)))
    assert rep.n_trained_tokens > 0 and rep.train_device_ms > 0.0
    assert np.isfinite(rep.beta).all()
    np.testing.assert_allclose(rep.beta.sum(1), 1.0, rtol=1e-5)
    assert s.backend.stats.gap_device_trains == 1
    assert s.backend.stats.train_uploads == 1


def test_cuda_device_raises_without_a_card(corpora):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(DeviceUnavailableError):
        tapi.MLegoSession(corpora[1][0], CFG)          # default: "cuda"
    with pytest.raises(DeviceUnavailableError):
        tapi.make_backend("device", device="cuda")
    with pytest.raises(DeviceUnavailableError):
        tapi.make_backend("device_sharded")


def test_unported_kinds_and_backends_raise(corpora):
    assert tapi.resolve_kind("gibbs") == tapi.resolve_kind("gs") == "gs"
    assert set(tapi.available_trainers()) >= {"vb", "gs"}
    with pytest.raises(ValueError, match="unknown model kind"):
        tapi.resolve_kind("lsa")
    sharded = tapi.make_backend("device_sharded", device="cpu")
    assert (sharded.name, sharded.shards) == ("device_sharded", 1)


@pytest.fixture(scope="module")
def gs_store_dir(tmp_path_factory):
    """Synthetic ΔN_kv counts tiling EDGES, saved once by the JAX package;
    one model carries the legacy "gibbs" tag."""
    rng = np.random.default_rng(8)
    store = JaxStore()
    for i, (lo, hi) in enumerate(zip(EDGES, EDGES[1:])):
        theta = {"delta_nkv": rng.poisson(3.0, (6, 150)).astype(np.float32)}
        store.add(japi.Interval(lo, hi), 50, 500, "gibbs" if i == 1 else "gs",
                  theta)
    path = tmp_path_factory.mktemp("shared_gs_store")
    store.save(str(path))
    return str(path)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_gs_store_from_jax_gives_equal_gap_free_beta(corpora, gs_store_dir,
                                                     backend):
    js = japi.MLegoSession(corpora[0][0], JCFG, kind="gs",
                           store=JaxStore.load(gs_store_dir),
                           backend=backend, seed=0)
    ts = tapi.MLegoSession(corpora[1][0], CFG, kind="gibbs",
                           store=ModelStore.load(gs_store_dir),
                           backend=backend, seed=0, device="cpu")
    for sigma in ([(0.0, 300.0)], [(0.0, 100.0), (200.0, 300.0)],
                  [(100.0, 300.0)]):
        rj = js.submit(_spec(japi, sigma, 1.0, "persist"))
        rt = ts.submit(_spec(tapi, sigma, 1.0, "persist"))
        assert rj.n_trained_tokens == rt.n_trained_tokens == 0
        assert rt.model_ids == rj.model_ids and rt.backend == backend
        np.testing.assert_allclose(rt.beta, rj.beta, **TOL)
    specs = [[(0.0, 300.0)], [(100.0, 300.0)], [(0.0, 200.0)]]
    bj = js.submit_many([_spec(japi, s, 0.0, "persist") for s in specs])
    bt = ts.submit_many([_spec(tapi, s, 0.0, "persist") for s in specs])
    for rj, rt in zip(bj, bt):
        np.testing.assert_allclose(rt.beta, rj.beta, **TOL)


def test_kernel_error_fails_the_query(corpora, store_dir, monkeypatch):
    def broken(*a, **kw):
        raise KernelError("merge_topics launch failed: CUDA error 9")
    monkeypatch.setattr(tbackend, "merge_topics_parts", broken)
    s = _port(corpora, store_dir, "device")
    with pytest.raises(KernelError):
        s.submit(tapi.QuerySpec(sigma=tapi.Interval(0.0, 300.0)))
    assert not isinstance(KernelError("x"), tapi.DeviceLostError)


def test_device_oom_replays_on_host(corpora, store_dir, monkeypatch):
    def oom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    monkeypatch.setattr(tbackend, "merge_topics_parts", oom)
    s = _port(corpora, store_dir, "device")
    rep = s.submit(tapi.QuerySpec(sigma=tapi.Interval(0.0, 300.0)))
    assert (rep.backend, rep.fallback_from) == ("host", "device")
    assert s.backend.quarantined


@pytest.mark.parametrize("route", ["host", "device_lost_replay"])
def test_every_gap_route_trains_through_the_estep_wrapper(corpora,
                                                          monkeypatch,
                                                          route):
    """The host backend's trainer and a replay after device loss both go
    through the E-step wrapper, which launches the kernel on the card."""
    from repro_torch.kernels.vb_estep import ops as estep_ops
    from repro_torch.testing.faults import FaultRule, injected
    calls = []
    real = estep_ops.vb_estep_csr

    def spy(csr, *a, **kw):
        calls.append(csr.device.type)
        return real(csr, *a, **kw)
    monkeypatch.setattr(estep_ops, "vb_estep_csr", spy)
    backend = "host" if route == "host" else "device"
    s = tapi.MLegoSession(corpora[1][0], CFG, backend=backend, device="cpu")
    with injected(FaultRule("backend.train_gap.device", kind="device_lost",
                            max_failures=1)):
        rep = s.submit(tapi.QuerySpec(sigma=tapi.Interval(0.0, 150.0)))
    assert rep.backend == "host" and rep.n_trained_tokens > 0
    assert rep.fallback_from == (None if route == "host" else "device")
    assert calls and set(calls) == {"cpu"}
    assert len(calls) == CFG.max_iters


def test_calibration_sidecar_is_the_ports_own(tmp_path):
    assert tapi.calibration_sidecar(str(tmp_path)) != \
        japi.calibration_sidecar(str(tmp_path))
