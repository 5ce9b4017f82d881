"""CUDA kernels of the port against their plain versions, on the card.

Every test here needs a CUDA card and skips without one (the check runs
inside the ``cuda`` fixture, never at import).  This file imports no JAX,
so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels.merge_topics import ops as merge_ops  # noqa: E402
from repro_torch.kernels.merge_topics.ref import (  # noqa: E402
    merge_topics_ref, merge_topics_segments_ref)
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
