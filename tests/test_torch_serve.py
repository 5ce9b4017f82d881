"""The serving layer of the PyTorch port against the JAX package's.

* the host-only logic (the coalescing queue, the circuit breaker, the
  latency tracker and SLO policy) runs as cases parametrised over both
  packages, so each holds the same contract;
* one store written by the JAX package on disk is loaded by both
  packages' services: the same covered specs from three tenants give
  equal Plan IR and ``plan_cached`` flags, and β at 1e-5 (covered plans
  only merge); gapped specs are held statistically, as
  ``tests/test_torch_session.py`` does (the trainers draw different
  random numbers);
* a port tenant evicted and revived continues its generator stream bit
  for bit;
* a kernel that fails inside a fused group fails queries and never
  opens the device breaker; only a lost device does, and the groups it
  then reroutes to "host" say so in ``fallback_from``;
* without a card, a service that asks for CUDA (the default) raises.

Every wait is bounded and every service is closed in a ``with`` block.
"""
import importlib
import threading

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.api as japi  # noqa: E402
import repro.serve as jserve  # noqa: E402
from repro.configs.lda_default import LDAConfig as JaxCfg  # noqa: E402
from repro.core.lda import log_predictive_probability  # noqa: E402
from repro.core.store import ModelStore as JaxStore  # noqa: E402
from repro.data.corpus import doc_term_matrix  # noqa: E402
from repro.data.corpus import make_corpus as jax_make_corpus  # noqa: E402
from repro.data.corpus import train_test_split as jax_split  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch.configs.lda_default import LDAConfig  # noqa: E402
from repro_torch.core.store import ModelStore  # noqa: E402
from repro_torch.data.corpus import make_corpus, train_test_split  # noqa: E402
from repro_torch.kernels.common import (  # noqa: E402
    DeviceUnavailableError, KernelError)
from repro_torch.testing.faults import FaultRule, injected  # noqa: E402

FIELDS = dict(n_topics=6, vocab_size=150, alpha=0.5, eta=0.05, max_iters=8,
              e_step_iters=5, gibbs_sweeps=6)
CFG = LDAConfig(**FIELDS)
JCFG = JaxCfg(**FIELDS)
EDGES = (0.0, 100.0, 200.0, 300.0)
TOL = dict(rtol=1e-5, atol=1e-5)
TIMEOUT = 60
PACKAGES = ["repro", "repro_torch"]


@pytest.fixture(params=PACKAGES)
def serve(request):
    """The ``serve`` package of one of the two packages."""
    return importlib.import_module(request.param + ".serve")


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
    path = tmp_path_factory.mktemp("shared_serve_store")
    store.save(str(path))
    return str(path)


def _jax_service(corpora, store_dir, **kw):
    return jserve.MLegoService(corpora[0][0], JCFG,
                               store=JaxStore.load(store_dir), **kw)


def _port_service(corpora, store_dir=None, **kw):
    store = ModelStore.load(store_dir) if store_dir else ModelStore()
    return tserve.MLegoService(corpora[1][0], CFG, store=store,
                               device="cpu", **kw)


def _spec(api, sigma, alpha=1.0, materialize="persist"):
    return api.QuerySpec(sigma=[api.Interval(lo, hi) for lo, hi in sigma],
                         alpha=alpha, materialize=materialize)


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


# ---------------------------------------------------------------------------
# host logic, both packages
# ---------------------------------------------------------------------------

def _pending(serve, api, lo=0.0, tenant="t", **opts):
    return serve.PendingQuery(spec=api.QuerySpec(sigma=api.Interval(lo, 10.0)),
                              tenant=tenant,
                              options=serve.SubmitOptions(**opts))


def _api(serve):
    return japi if serve is jserve else tapi


def test_queue_drains_windows_up_to_max_width(serve):
    api = _api(serve)
    q = serve.CoalescingQueue(window_s=0.2, max_width=2)
    for i in range(5):
        q.put(_pending(serve, api, lo=float(i)))
    assert [len(q.drain(timeout=0.1)) for _ in range(4)] == [2, 2, 1, 0]


def test_queue_sheds_and_displaces_by_priority(serve):
    api = _api(serve)
    shed = []
    q = serve.CoalescingQueue(window_s=0.0, max_queue=2,
                              on_shed=lambda it: shed.append(it.tenant))
    q.put(_pending(serve, api, tenant="low", priority=0))
    q.put(_pending(serve, api, tenant="mid", priority=1))
    with pytest.raises(serve.ShedError):
        q.put(_pending(serve, api, tenant="late", priority=0))
    q.put(_pending(serve, api, tenant="high", priority=2))
    assert shed == ["low"], "the youngest lower-priority entry is displaced"
    assert [p.tenant for p in q.drain(timeout=0.1)] == ["high", "mid"]


def test_queue_close_rejects_put_but_drains(serve):
    api = _api(serve)
    q = serve.CoalescingQueue(window_s=0.0)
    q.put(_pending(serve, api))
    q.close()
    with pytest.raises(RuntimeError, match="closed"):
        q.put(_pending(serve, api))
    assert len(q.drain(timeout=0.01)) == 1
    with pytest.raises(ValueError, match="window_s"):
        serve.CoalescingQueue(window_s=-1.0)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_breaker_opens_probes_and_closes(serve):
    clock = _Clock()
    seen = []
    cb = serve.CircuitBreaker(
        serve.BreakerPolicy(window=10, failure_threshold=0.5, min_samples=5,
                            cooldown_s=1.0, half_open_probes=2),
        clock=clock, on_transition=lambda old, new: seen.append((old, new)))
    for _ in range(4):
        cb.record_failure()
    assert cb.state == serve.CLOSED and cb.allow()
    cb.record_failure()
    assert cb.state == serve.OPEN and not cb.allow()
    clock.t = 1.5
    assert cb.allow() and cb.allow() and not cb.allow()
    cb.record_success()
    cb.record_success()
    assert cb.state == serve.CLOSED and cb.snapshot().window == 0
    cb.record_failure(hard=True)
    assert cb.state == serve.OPEN
    assert seen == [(serve.CLOSED, serve.OPEN), (serve.OPEN, serve.HALF_OPEN),
                    (serve.HALF_OPEN, serve.CLOSED),
                    (serve.CLOSED, serve.OPEN)]


def test_latency_tracker_and_slo_levels(serve):
    tr = serve.LatencyTracker(window=8)
    for v in (1.0, 2.0, 3.0, 4.0):
        tr.observe(v)
    assert (tr.p50, tr.p95, len(tr)) == (3.0, 4.0, 4)
    for v in (10.0,) * 8:
        tr.observe(v)
    assert tr.p50 == 10.0
    pol = serve.SLOPolicy(p95_slo_s=1.0, min_samples=2)
    slow = serve.LatencyTracker()
    slow.observe(1.5)
    assert pol.level(slow) == 0, "min_samples guards a trivial window"
    slow.observe(1.5)
    assert pol.level(slow) == 1
    assert [pol.alpha_factor(lv) for lv in (0, 1, 3)] == [1.0, 0.5, 0.0]
    with pytest.raises(ValueError, match="ordered"):
        serve.SLOPolicy(p95_slo_s=1.0, degrade_at=3.0, heavy_at=2.0)


# ---------------------------------------------------------------------------
# the port's service against the JAX package's, over one store on disk
# ---------------------------------------------------------------------------

COVERED = [[(0.0, 300.0)], [(0.0, 100.0), (200.0, 300.0)], [(100.0, 300.0)],
           [(0.0, 300.0)]]
TENANTS = ("ana", "bob", "cy")


def _answer_in_turn(svc, api):
    """Each tenant asks every covered spec, one answer at a time."""
    return [svc.submit(_spec(api, s), tenant=t).result(timeout=TIMEOUT)
            for t in TENANTS for s in COVERED]


@pytest.mark.parametrize("backend", ["host", "device"])
def test_covered_specs_from_three_tenants_match_the_jax_service(
        corpora, store_dir, backend):
    with _jax_service(corpora, store_dir, backend=backend,
                      window_s=0.0) as js:
        want = _answer_in_turn(js, japi)
    with _port_service(corpora, store_dir, backend=backend,
                       window_s=0.0) as ts:
        got = _answer_in_turn(ts, tapi)
        rep = ts.report()
    assert [r.plan_cached for r in got] == [r.plan_cached for r in want]
    assert sum(r.plan_cached for r in got) >= len(TENANTS) * len(COVERED) - 3
    for rt, rj in zip(got, want):
        assert [_ir(p.ir) for p in rt.plans] == [_ir(p.ir) for p in rj.plans]
        assert rt.model_ids == rj.model_ids and rt.n_trained_tokens == 0
        assert rt.backend == backend and rt.fallback_from is None
        np.testing.assert_allclose(rt.beta, rj.beta, **TOL)
    assert rep.queries == len(got) and rep.errors == 0


def test_fused_tenant_window_merges_like_the_jax_service(corpora, store_dir):
    """Three tenants submitting at once fuse into ``submit_many`` groups
    (one ragged merge on the device backend); every β still equals the
    JAX service's answer to the same spec."""
    with _jax_service(corpora, store_dir, backend="device",
                      window_s=0.0) as js:
        want = [js.submit(_spec(japi, s)).result(timeout=TIMEOUT)
                for s in COVERED]
    barrier = threading.Barrier(len(TENANTS))
    futs = {}
    with _port_service(corpora, store_dir, backend="device", window_s=0.3,
                       max_width=16) as ts:
        def client(tenant):
            barrier.wait(timeout=TIMEOUT)
            futs[tenant] = [ts.submit(_spec(tapi, s), tenant=tenant)
                            for s in COVERED]

        threads = [threading.Thread(target=client, args=(t,))
                   for t in TENANTS]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=TIMEOUT)
            assert not th.is_alive()
        got = {t: [f.result(timeout=TIMEOUT) for f in fs]
               for t, fs in futs.items()}
        rep = ts.report()
        ragged = ts.backend.stats.device_launches
    assert rep.max_coalesce_width >= 2 and rep.coalesced_groups >= 1
    assert ragged < rep.queries, "fused groups launch one ragged merge"
    for t in TENANTS:
        for rt, rj in zip(got[t], want):
            assert rt.backend == "device" and rt.model_ids == rj.model_ids
            np.testing.assert_allclose(rt.beta, rj.beta, **TOL)


def test_gapped_answers_within_the_jax_services_seed_spread(corpora,
                                                            store_dir):
    """A gapped volatile spec through each package's service: the port's
    held-out log predictive probability, averaged over two seeds, lies in
    the spread of two JAX seeds (widened by that spread on each side)."""
    spec = [(50.0, 250.0)]
    x_test = doc_term_matrix(corpora[0][1])
    lpp_j, lpp_t = [], []
    for seed in (0, 1):
        with _jax_service(corpora, store_dir, backend="device", seed=seed,
                          window_s=0.0) as js:
            rep = js.submit(_spec(japi, spec, 0.0, "volatile"),
                            tenant="ana").result(timeout=TIMEOUT)
        lpp_j.append(log_predictive_probability(rep.beta, x_test))
        with _port_service(corpora, store_dir, backend="device", seed=seed,
                           window_s=0.0) as ts:
            rep = ts.submit(_spec(tapi, spec, 0.0, "volatile"),
                            tenant="ana").result(timeout=TIMEOUT)
        assert rep.n_trained_tokens > 0 and rep.train_device_ms > 0.0
        lpp_t.append(log_predictive_probability(rep.beta, x_test))
    spread = abs(lpp_j[0] - lpp_j[1])
    assert min(lpp_j) - spread <= np.mean(lpp_t) <= max(lpp_j) + spread, \
        (lpp_t, lpp_j)


def _two_gapped_answers(corpora, store_dir, evict):
    spec = _spec(tapi, [(50.0, 250.0)], 0.0, "volatile")
    with _port_service(corpora, store_dir, backend="device", seed=7,
                       window_s=0.0) as svc:
        first = svc.submit(spec, tenant="ana").result(timeout=TIMEOUT)
        if evict:
            assert svc.evict_idle(idle_s=0.0) == 1
            assert "ana" not in svc.tenants()
        second = svc.submit(spec, tenant="ana").result(timeout=TIMEOUT)
        evictions = svc.report().tenant("ana").evictions
    return first, second, evictions


def test_evicted_tenant_continues_its_generator_stream(corpora, store_dir):
    a1, a2, n_evicted = _two_gapped_answers(corpora, store_dir, evict=True)
    b1, b2, n_smooth = _two_gapped_answers(corpora, store_dir, evict=False)
    assert (n_evicted, n_smooth) == (1, 0)
    assert a2.n_trained_tokens > 0
    np.testing.assert_array_equal(a1.beta, b1.beta)
    np.testing.assert_array_equal(a2.beta, b2.beta)
    assert not np.array_equal(a1.beta, a2.beta), \
        "the second answer draws further along the stream"


def _planted_kernel_error(*args, **kwargs):
    raise KernelError("planted: the kernel did not launch")


# a kernel wrapper that the fused group reaches, and specs that reach it:
# covered specs merge in one ragged launch; gapped ones train on the E-step
BROKEN = {
    "ragged merge": ("repro_torch.api.backend", "merge_topics_ragged",
                     [_spec(tapi, s) for s in COVERED[:3]]),
    "E-step": ("repro_torch.kernels.vb_estep.ops", "vb_estep_csr",
               [_spec(tapi, [(50.0, 250.0)], 0.0, "volatile"),
                _spec(tapi, [(20.0, 120.0)], 0.0, "volatile")]),
}
HOLD_OPEN = dict(window=10, failure_threshold=0.5, min_samples=2,
                 cooldown_s=600.0)


def _results(futs):
    out = []
    for f in futs:
        try:
            out.append(f.result(timeout=TIMEOUT))
        except KernelError:
            out.append(None)
    return out


@pytest.mark.parametrize("broken", sorted(BROKEN))
def test_a_kernel_error_never_opens_the_device_breaker(corpora, store_dir,
                                                        monkeypatch, broken):
    """A kernel that fails inside a fused group fails what it reaches —
    bisection answers covered specs with the single merge, gapped ones
    fail — and nothing more: the device breaker stays closed, and no
    later answer comes from "host"."""
    module, name, specs = BROKEN[broken]
    with _port_service(corpora, store_dir, backend="device", window_s=0.3,
                       max_width=16,
                       breaker=tserve.BreakerPolicy(**HOLD_OPEN)) as svc:
        monkeypatch.setattr(importlib.import_module(module), name,
                            _planted_kernel_error)
        hit = _results([svc.submit(spec, tenant=t)
                        for t in TENANTS for spec in specs])
        monkeypatch.undo()
        later = [svc.submit(_spec(tapi, COVERED[0]), tenant=t).result(
            timeout=TIMEOUT) for t in TENANTS]
        rep = svc.report()
    assert rep.bisect_retries >= 1, "the fault did not meet a fused group"
    if broken == "E-step":
        assert hit == [None] * len(hit)
    answered = [r for r in hit if r is not None] + later
    assert len(answered) == len(later) + (len(hit) if broken ==
                                          "ragged merge" else 0)
    assert all(r.backend == "device" and r.fallback_from is None
               for r in answered)
    br = rep.breaker["device"]
    assert br.state == tserve.CLOSED and br.opens == 0
    assert rep.breaker_reroutes == 0


def test_a_lost_device_reroutes_its_later_groups_to_host_visibly(
        corpora, store_dir):
    """A lost device trips the breaker at once; the queries it then
    reroutes are answered on "host" and name "device" in
    ``fallback_from``, as the query that met the loss does."""
    with _port_service(corpora, store_dir, backend="device", window_s=0.0,
                       breaker=tserve.BreakerPolicy(**HOLD_OPEN)) as svc:
        with injected(FaultRule("backend.merge.device", kind="device_lost",
                                max_failures=1)):
            lost = svc.submit(_spec(tapi, COVERED[0]), tenant="ana").result(
                timeout=TIMEOUT)
        later = svc.submit(_spec(tapi, COVERED[2]), tenant="bob").result(
            timeout=TIMEOUT)
        rep = svc.report()
    assert rep.breaker["device"].state == tserve.OPEN
    assert rep.breaker_reroutes == 1
    for r in (lost, later):
        assert (r.backend, r.fallback_from) == ("host", "device")
        assert np.isfinite(r.beta).all()


def test_service_runs_every_tenant_on_its_device(corpora):
    with _port_service(corpora, backend="device", window_s=0.0) as svc:
        assert svc.device == torch.device("cpu")
        assert svc.backend.device == torch.device("cpu")
        assert svc.session("ana").device == torch.device("cpu")
        assert svc._shared_backend("host").name == "host"
        rep = svc.submit(_spec(tapi, [(0.0, 100.0)], 0.0, "volatile"),
                         tenant="ana").result(timeout=TIMEOUT)
    assert rep.backend == "device" and rep.n_trained_tokens > 0


def test_service_asks_for_cuda_by_default(corpora):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(DeviceUnavailableError):
        tserve.MLegoService(corpora[1][0], CFG)
    with pytest.raises(DeviceUnavailableError):
        tserve.MLegoService(corpora[1][0], CFG, backend="host")


def test_many_tenants_under_a_short_switch_interval(corpora, store_dir):
    """More workers than cores and a short switch interval: every answer
    arrives, and the per-tenant counters add up to the service's."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        tenants = [f"t{i}" for i in range(8)]
        with _port_service(corpora, store_dir, backend="device",
                           window_s=0.01, workers_per_pool=8) as svc:
            futs = []

            def client(tenant):
                futs.extend(svc.submit(_spec(tapi, s), tenant=tenant)
                            for s in COVERED)

            threads = [threading.Thread(target=client, args=(t,))
                       for t in tenants]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=TIMEOUT)
                assert not th.is_alive()
            reps = [f.result(timeout=TIMEOUT) for f in futs]
            rep = svc.report()
    finally:
        sys.setswitchinterval(old)
    n = len(tenants) * len(COVERED)
    assert len(reps) == n and rep.queries == n and rep.errors == 0
    assert sum(rep.tenant(t).queries for t in tenants) == n
    assert all(r.backend == "device" and np.isfinite(r.beta).all()
               for r in reps)
