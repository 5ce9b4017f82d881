"""CUDA kernels of the port against their plain versions, on the card.

Every test here needs a CUDA card and skips without one (the check runs
inside the ``cuda`` fixture, never at import).  This file imports no JAX,
so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.gibbs_sweep import ops as gibbs_ops  # noqa: E402
from repro_torch.kernels.gibbs_sweep.ref import (  # noqa: E402
    cgs_sweep_exact_ref, gibbs_sweep_ref)
from repro_torch.kernels.merge_topics import ops as merge_ops  # noqa: E402
from repro_torch.kernels.merge_topics.ref import (  # noqa: E402
    merge_topics_batched_ref, merge_topics_ref, merge_topics_segments_ref)
from repro_torch.kernels.vb_estep import ops as estep_ops  # noqa: E402
from repro_torch.kernels.vb_estep.ref import vb_estep_ref  # noqa: E402

pytestmark = pytest.mark.cuda

RNG = np.random.default_rng(11)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _t(a, dev):
    return torch.tensor(a, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("n,k,v", [(1, 16, 64), (5, 100, 300), (12, 128, 512),
                                   (3, 7, 33), (8, 100, 8192)])
def test_merge_kernel_matches_plain(cuda, n, k, v):
    st = _t(RNG.normal(size=(n, k, v)), cuda)
    w = _t(RNG.uniform(0.2, 2.0, n), cuda)
    before = merge_ops.merge_topics_launches
    got = merge_ops.merge_topics(st, w, bias=0.05, base=0.05)
    torch.cuda.synchronize()
    assert merge_ops.merge_topics_launches == before + 1
    torch.testing.assert_close(got, merge_topics_ref(st, w, 0.05, 0.05),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("counts", [[1], [1, 1, 1], [3, 3, 3],
                                    [5, 4, 3, 2, 1], [1, 1, 1, 16],
                                    [1, 3, 8, 2]])
@pytest.mark.parametrize("k,v", [(12, 128), (6, 150)])
def test_ragged_kernel_matches_plain(cuda, counts, k, v):
    r = sum(counts)
    st = _t(RNG.gamma(1.0, 1.0, (r, k, v)), cuda)
    w = _t(RNG.uniform(0.2, 2.0, r), cuda)
    got = merge_ops.merge_topics_segments(st, w, counts, 0.05, 0.05)
    torch.testing.assert_close(
        got, merge_topics_segments_ref(st, w, counts, 0.05, 0.05),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,v,k", [(32, 128, 16), (65, 200, 100),
                                   (128, 384, 128), (8, 64, 10),
                                   (135, 150, 6), (300, 192, 12),
                                   (17, 300, 256)])
def test_estep_kernel_matches_plain(cuda, d, v, k):
    x = _t(RNG.poisson(0.5, (d, v)), cuda)
    eeb = RNG.gamma(1.0, 1.0, (k, v))
    eeb = _t(eeb / eeb.sum(1, keepdims=True), cuda)
    g0 = torch.ones((d, k), device=cuda)
    before = estep_ops.launches
    g1, s1 = estep_ops.vb_estep(x, eeb, g0, 0.5, 8)
    torch.cuda.synchronize()
    assert estep_ops.launches == before + 2
    g2, s2 = vb_estep_ref(x, eeb, g0, 0.5, 8)
    torch.testing.assert_close(g1, g2, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s1, s2, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("route", ["host", "device_lost_replay"])
def test_every_gap_route_launches_the_estep_kernel(cuda, route):
    """A gap trained by the "host" backend, and one replayed on it after
    the device backend lost its device, both run the E-step kernel."""
    from repro_torch.api import Interval, MLegoSession, QuerySpec
    from repro_torch.configs.lda_default import LDAConfig
    from repro_torch.data.corpus import make_corpus
    from repro_torch.testing.faults import FaultRule, injected
    cfg = LDAConfig(n_topics=6, vocab_size=150, max_iters=4, e_step_iters=5)
    corpus, _ = make_corpus(300, 150, 6, mean_doc_len=30, seed=3)
    backend = "host" if route == "host" else "device"
    s = MLegoSession(corpus, cfg, backend=backend, device="cuda")
    before = estep_ops.launches
    with injected(FaultRule("backend.train_gap.device", kind="device_lost",
                            max_failures=1)):
        rep = s.submit(QuerySpec(sigma=Interval(0.0, 150.0)))
    torch.cuda.synchronize()
    assert rep.backend == "host" and rep.n_trained_tokens > 0
    assert rep.fallback_from == (None if route == "host" else "device")
    assert estep_ops.launches == before + 2 * cfg.max_iters
    assert np.isfinite(rep.beta).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    st = torch.ones((2, 4, 8), device=cuda)
    with pytest.raises(ValueError):
        merge_ops.merge_topics(st.transpose(1, 2), torch.ones(2, device=cuda))
    with pytest.raises(ValueError):
        merge_ops.merge_topics(st.double(),
                               torch.ones(2, device=cuda).double())
    x = torch.ones((4, 8), device=cuda)
    with pytest.raises(ValueError):
        estep_ops.vb_estep(x, torch.ones((300, 8), device=cuda),
                           torch.ones((4, 300), device=cuda), 0.5, 2)


@pytest.mark.parametrize("b,n,k,v", [(4, 8, 100, 8192), (3, 2, 6, 150),
                                     (2, 5, 7, 33), (1, 3, 16, 64)])
def test_batched_merge_kernel_matches_plain(cuda, b, n, k, v):
    st = _t(RNG.gamma(1.0, 1.0, (b, n, k, v)), cuda)
    w = _t(RNG.uniform(0.2, 2.0, (b, n)), cuda)
    before = merge_ops.merge_topics_batch_launches
    got = merge_ops.merge_topics_batch(st, w, 0.05, 0.05)
    torch.cuda.synchronize()
    assert merge_ops.merge_topics_batch_launches == before + 1
    torch.testing.assert_close(got, merge_topics_batched_ref(st, w, 0.05, 0.05),
                               rtol=1e-5, atol=1e-5)


def _blocked_inputs(b, t, bd, k, v, dev):
    """A blocked-sweep state: sorted local docs, a ragged last block
    (pad slots at its tail), and a snapshot prior made from counts."""
    words = RNG.integers(0, v, (b, t)).astype(np.int32)
    ldoc = np.sort(RNG.integers(0, bd, (b, t)), axis=1).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[-1, t // 2:] = 0.0
    words[-1, t // 2:] = 0
    ldoc[-1, t // 2:] = 0
    z = RNG.integers(0, k, (b, t)).astype(np.int32)
    nkd = np.zeros((b, bd, k), np.float32)
    nkv = np.zeros((k, v), np.float32)
    for i in range(b):
        np.add.at(nkd[i], (ldoc[i], z[i]), mask[i])
    np.add.at(nkv, (z.ravel(), words.ravel()), mask.ravel())
    glob = RNG.integers(0, 4, (k, v)).astype(np.float32)
    prior = nkv + glob + np.float32(0.05)
    prior_k = nkv.sum(1) + glob.sum(1) + np.float32(v * 0.05)
    u = RNG.uniform(size=(b, t)).astype(np.float32)
    ints = [torch.tensor(a, device=dev) for a in (words, ldoc)]
    return (*ints, _t(mask, dev), _t(u, dev), torch.tensor(z, device=dev),
            _t(nkd, dev), _t(prior, dev), _t(prior_k, dev))


@pytest.mark.parametrize("b,t,bd,k,v", [(3, 57, 7, 6, 150), (5, 200, 32, 8, 300),
                                        (2, 90, 16, 33, 64),
                                        (4, 300, 64, 100, 1000),
                                        (1, 40, 8, 200, 100)])
def test_gibbs_sweep_kernel_matches_plain(cuda, b, t, bd, k, v):
    args = _blocked_inputs(b, t, bd, k, v, cuda)
    before = gibbs_ops.gibbs_sweep_launches
    z1, nkd1, nkv1 = gibbs_ops.gibbs_sweep(*args, 0.5)
    torch.cuda.synchronize()
    assert gibbs_ops.gibbs_sweep_launches == before + 1
    z2, nkd2, nkv2 = gibbs_sweep_ref(*args, 0.5)
    mask = args[2]
    # pad slots keep their topic; counts are conserved
    assert torch.equal(z1[mask == 0], args[4][mask == 0])
    assert float(nkv1.sum()) == float(mask.sum())
    torch.testing.assert_close(nkd1.sum(2), args[5].sum(2), rtol=0, atol=0)
    # the plain version adds the conditional in the warp scan's order,
    # so the two agree draw for draw
    assert torch.equal(z1, z2)
    assert torch.equal(nkd1, nkd2) and torch.equal(nkv1, nkv2)


@pytest.mark.parametrize("t,d,k,v", [(300, 20, 6, 150), (800, 30, 40, 300),
                                     (2000, 40, 100, 8192),
                                     # a 1,000-document gap of the main path
                                     (58000, 1000, 100, 8192)])
def test_cgs_sweep_exact_kernel_matches_plain(cuda, t, d, k, v):
    docs = np.sort(RNG.integers(0, d, t)).astype(np.int32)
    toks = RNG.integers(0, v, t).astype(np.int32)
    z = RNG.integers(0, k, t).astype(np.int32)
    nkd = np.zeros((d, k), np.float32)
    nkv = np.zeros((k, v), np.float32)
    np.add.at(nkd, (docs, z), 1.0)
    np.add.at(nkv, (z, toks), 1.0)
    glob = RNG.integers(0, 4, (k, v)).astype(np.float32)
    args = (torch.tensor(toks, device=cuda), torch.tensor(docs, device=cuda),
            _t(RNG.uniform(size=t), cuda), torch.tensor(z, device=cuda),
            _t(nkd, cuda), _t(nkv, cuda), _t(nkv.sum(1), cuda),
            _t(glob, cuda), _t(glob.sum(1), cuda))
    before = gibbs_ops.cgs_sweep_exact_launches
    z1, nkd1, nkv1, nk1 = gibbs_ops.cgs_sweep_exact(*args, 0.5, 0.05)
    torch.cuda.synchronize()
    assert gibbs_ops.cgs_sweep_exact_launches == before + 1
    z2, nkd2, nkv2, nk2 = cgs_sweep_exact_ref(*args, 0.5, 0.05)
    assert float(nkv1.sum()) == t
    torch.testing.assert_close(nkd1.sum(1), args[4].sum(1), rtol=0, atol=0)
    torch.testing.assert_close(nk1, nkv1.sum(1), rtol=0, atol=0)
    assert torch.equal(z1, z2) and torch.equal(nkv1, nkv2)
    assert torch.equal(nkd1, nkd2) and torch.equal(nk1, nk2)


def _gs_session(backend):
    from repro_torch.api import MLegoSession
    from repro_torch.configs.lda_default import LDAConfig
    from repro_torch.data.corpus import make_corpus
    cfg = LDAConfig(n_topics=6, vocab_size=150, gibbs_sweeps=4)
    corpus, _ = make_corpus(300, 150, 6, mean_doc_len=30, seed=3)
    return cfg, MLegoSession(corpus, cfg, kind="gs", backend=backend,
                             device="cuda")


@pytest.mark.parametrize("route", ["host", "device_lost_replay"])
def test_every_gs_gap_route_launches_the_exact_scan_kernel(cuda, route):
    """A "gs" gap trained by the "host" backend, and one replayed on it
    after the device backend lost its device, both run the exact-scan
    kernel, one launch per sweep."""
    from repro_torch.api import Interval, QuerySpec
    from repro_torch.testing.faults import FaultRule, injected
    cfg, s = _gs_session("host" if route == "host" else "device")
    before = gibbs_ops.cgs_sweep_exact_launches
    blocked = gibbs_ops.gibbs_sweep_launches
    with injected(FaultRule("backend.train_gap.device", kind="device_lost",
                            max_failures=1)):
        rep = s.submit(QuerySpec(sigma=Interval(0.0, 150.0)))
    torch.cuda.synchronize()
    assert rep.backend == "host" and rep.n_trained_tokens > 0
    assert rep.fallback_from == (None if route == "host" else "device")
    assert gibbs_ops.cgs_sweep_exact_launches == before + cfg.gibbs_sweeps
    assert gibbs_ops.gibbs_sweep_launches == blocked
    assert np.isfinite(rep.beta).all()


def test_gs_device_route_launches_the_blocked_kernel(cuda):
    from repro_torch.api import Interval, QuerySpec
    cfg, s = _gs_session("device")
    before = gibbs_ops.gibbs_sweep_launches
    exact = gibbs_ops.cgs_sweep_exact_launches
    merges = merge_ops.merge_topics_launches
    rep = s.submit(QuerySpec(sigma=Interval(0.0, 150.0)))
    torch.cuda.synchronize()
    assert (rep.backend, rep.fallback_from) == ("device", None)
    assert gibbs_ops.gibbs_sweep_launches == before + cfg.gibbs_sweeps
    assert gibbs_ops.cgs_sweep_exact_launches == exact
    assert merge_ops.merge_topics_launches == merges + 1
    assert rep.train_device_ms > 0.0
    np.testing.assert_allclose(rep.beta.sum(1), 1.0, rtol=1e-5)


def test_gibbs_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    args = list(_blocked_inputs(2, 10, 4, 6, 20, cuda))
    bad = list(args)
    bad[0] = args[0].long()                       # words must be int32
    with pytest.raises(ValueError):
        gibbs_ops.gibbs_sweep(*bad, 0.5)
    big = list(args)
    big[5] = torch.zeros((2, 4096, 64), device=cuda)   # n_kd over 227 KB
    big[6] = torch.ones((64, 20), device=cuda)
    big[7] = torch.ones(64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        gibbs_ops.gibbs_sweep(*big, 0.5)
    with pytest.raises(ValueError):
        gibbs_ops.gibbs_sweep(*args[:4], args[4].cpu(), *args[5:], 0.5)
