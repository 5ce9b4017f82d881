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
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.kernels.common import KernelError  # noqa: E402
from repro_torch.kernels.slstm_scan import ops as slstm_ops  # noqa: E402
from repro_torch.kernels.slstm_scan.ref import (  # noqa: E402
    slstm_scan_ref, zero_state)

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


ESTEP_SHAPES = [(32, 128, 16), (65, 200, 100), (128, 384, 128), (8, 64, 10),
                (135, 150, 6), (300, 192, 12), (17, 300, 256)]


def _estep_inputs(x_np, k, dev):
    v = x_np.shape[1]
    eeb = RNG.gamma(1.0, 1.0, (k, v))
    eeb = _t(eeb / eeb.sum(1, keepdims=True), dev)
    return _t(x_np, dev), eeb, torch.ones((x_np.shape[0], k), device=dev)


def _hold_csr_to_dense(x, eeb, g0, n_iters=8):
    """The CSR kernel on doc_term_csr(x) against the dense plain version."""
    csr = estep_ops.doc_term_csr(x)
    before = estep_ops.launches
    g1, s1 = estep_ops.vb_estep_csr(csr, eeb, g0, 0.5, n_iters)
    torch.cuda.synchronize()
    assert estep_ops.launches == before + 2
    g2, s2 = vb_estep_ref(x, eeb, g0, 0.5, n_iters)
    torch.testing.assert_close(g1, g2, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(s1, s2, rtol=2e-4, atol=2e-4)
    return csr, g1, s1


@pytest.mark.parametrize("d,v,k", ESTEP_SHAPES)
def test_csr_estep_kernel_matches_dense_plain(cuda, d, v, k):
    x, eeb, g0 = _estep_inputs(RNG.poisson(0.5, (d, v)), k, cuda)
    _hold_csr_to_dense(x, eeb, g0)


@pytest.mark.parametrize("d,v,k", [(17, 300, 256), (6, 2000, 100)])
def test_csr_estep_kernel_streams_long_documents(cuda, d, v, k):
    """Documents with more nonzeros than a warp's row budget stream their
    rows in chunks every iteration (the plan says which do)."""
    x, eeb, g0 = _estep_inputs(RNG.poisson(0.5, (d, v)), k, cuda)
    csr, _, _ = _hold_csr_to_dense(x, eeb, g0)
    rows_per_cta, _ = estep_ops.estep_plan(k, csr.max_row)
    assert rows_per_cta < csr.max_row


def test_csr_estep_kernel_on_a_corpus(cuda):
    """A make_corpus block at the main path's widths (K = 100, V = 8,192),
    empty columns included, with a row and a column emptied by hand."""
    from repro_torch.data.corpus import doc_term_matrix, make_corpus
    corpus, beta = make_corpus(300, 8192, 100, mean_doc_len=60, seed=5)
    x_np = doc_term_matrix(corpus)
    x_np[7] = 0.0
    x_np[:, int(np.argmax(x_np.sum(0)))] = 0.0
    x = _t(x_np, cuda)
    eeb = _t(beta + 1e-4, cuda)
    eeb = (eeb / eeb.sum(1, keepdim=True)).contiguous()
    g0 = torch.ones((300, 100), device=cuda)
    _hold_csr_to_dense(x, eeb, g0, n_iters=20)


def test_csr_estep_kernel_is_bitwise_repeatable(cuda):
    x, eeb, g0 = _estep_inputs(RNG.poisson(0.5, (65, 200)), 100, cuda)
    csr = estep_ops.doc_term_csr(x)
    first = estep_ops.vb_estep_csr(csr, eeb, g0, 0.5, 8)
    for _ in range(5):
        again = estep_ops.vb_estep_csr(csr, eeb, g0, 0.5, 8)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])


@pytest.mark.parametrize("n,k,v", [(1, 100, 8192), (8, 100, 8192),
                                   (129, 12, 128), (8, 7, 33), (129, 5, 7)])
@pytest.mark.parametrize("weights_on", ["host", "device"])
def test_parts_merge_kernel_matches_plain(cuda, n, k, v, weights_on):
    """n separate parts through the pointer table (by value up to 128,
    a device table above), K·V a multiple of 4 or not."""
    parts = [_t(RNG.gamma(1.0, 1.0, (k, v)), cuda) for _ in range(n)]
    w_np = RNG.uniform(0.2, 2.0, n).astype(np.float32)
    w = _t(w_np, cuda) if weights_on == "device" else list(w_np)
    before = merge_ops.merge_topics_launches
    got = merge_ops.merge_topics_parts(parts, w, bias=0.05, base=0.05)
    torch.cuda.synchronize()
    assert merge_ops.merge_topics_launches == before + 1
    want = merge_topics_ref(torch.stack(parts), _t(w_np, cuda), 0.05, 0.05)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for _ in range(5):
        assert torch.equal(
            merge_ops.merge_topics_parts(parts, w, bias=0.05, base=0.05), got)


def test_parts_merge_kernel_reads_misaligned_parts(cuda):
    """A part that starts off a 16-byte boundary takes the scalar path."""
    k, v = 12, 64
    parts = [_t(RNG.normal(size=(k, v)), cuda) for _ in range(3)]
    flat = _t(RNG.normal(size=(k * v + 1,)), cuda)
    parts.append(flat[1:].view(k, v))
    w = [0.5, 1.0, 1.5, 2.0]
    got = merge_ops.merge_topics_parts(parts, w)
    want = merge_topics_ref(torch.stack(parts), _t(w, cuda))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


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
    with pytest.raises(ValueError):
        merge_ops.merge_topics_parts([st[0], st[1].t()], [1.0, 1.0])
    with pytest.raises(ValueError):
        merge_ops.merge_topics_parts([st[0], st[1]], [1.0])


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


def _ldoc(layout, b, t, bd):
    """Local documents of a (B, T) layout: "sorted" (as ``blocked_layout``
    makes them), "interleaved" (each slot's document drawn at random, so
    a document's tokens are scattered over the block), "gaps" (only the
    even documents have tokens) and "long" (all tokens in the first two
    documents, chains longer than 32 and 96 tokens)."""
    if layout == "sorted":
        return np.sort(RNG.integers(0, bd, (b, t)), axis=1)
    if layout == "interleaved":
        return RNG.integers(0, bd, (b, t))
    if layout == "gaps":
        return 2 * RNG.integers(0, (bd + 1) // 2, (b, t))
    return RNG.integers(0, min(2, bd), (b, t))


def _blocked_inputs(b, t, bd, k, v, dev, layout="sorted"):
    """A blocked-sweep state: local docs laid out as ``_ldoc`` says, a
    ragged last block (pad slots at its tail), and a snapshot prior made
    from counts."""
    words = RNG.integers(0, v, (b, t)).astype(np.int32)
    ldoc = _ldoc(layout, b, t, bd).astype(np.int32)
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


def _check_blocked(args):
    """One kernel sweep against the plain version: the same bits."""
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


@pytest.mark.parametrize("b,t,bd,k,v", [(3, 57, 7, 6, 150), (5, 200, 32, 8, 300),
                                        (2, 90, 16, 33, 64),
                                        (4, 300, 64, 100, 1000),
                                        (1, 40, 8, 200, 100)])
def test_gibbs_sweep_kernel_matches_plain(cuda, b, t, bd, k, v):
    _check_blocked(_blocked_inputs(b, t, bd, k, v, cuda))


@pytest.mark.parametrize("layout,b,t,bd,k,v", [
    ("interleaved", 3, 200, 8, 20, 100),
    ("interleaved", 4, 300, 64, 100, 1000),
    ("gaps", 3, 150, 16, 12, 80),            # documents with no tokens
    ("long", 2, 300, 8, 40, 200),            # chains of ~150 tokens
    ("long", 3, 97, 1, 7, 50),               # one document a block: 97, 48
    ("interleaved", 2, 600, 4096, 64, 200),  # BD x K x 4 = 1 MB a block
    ("interleaved", 3, 120, 8, 1, 40),       # K = 1
    ("interleaved", 2, 100, 8, 1024, 300),   # K = 1024, 32 topics a lane
])
def test_gibbs_sweep_kernel_on_every_doc_layout(cuda, layout, b, t, bd, k, v):
    """One warp a document: documents scattered over their block, empty
    documents, chains longer than a 32-slot chunk and than three, a
    block wider than shared memory could hold, and K at both ends."""
    _check_blocked(_blocked_inputs(b, t, bd, k, v, cuda, layout))


@pytest.mark.parametrize("layout", ["sorted", "interleaved", "gaps", "long"])
def test_doc_index_on_the_card_matches_the_cpu(cuda, layout):
    ldoc = torch.tensor(_ldoc(layout, 4, 90, 16), dtype=torch.int32)
    mask = torch.ones((4, 90))
    mask[-1, 50:] = 0.0
    want = gibbs_ops.doc_index(ldoc, mask, 16)
    got = gibbs_ops.doc_index(ldoc.to(cuda), mask.to(cuda), 16)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g.cpu(), w)


def _exact_inputs(dev, t, d, k, v, docs=None, toks=None):
    docs = np.sort(RNG.integers(0, d, t)) if docs is None else docs
    toks = RNG.integers(0, v, t) if toks is None else toks
    docs, toks = docs.astype(np.int32), toks.astype(np.int32)
    z = RNG.integers(0, k, t).astype(np.int32)
    nkd = np.zeros((d, k), np.float32)
    nkv = np.zeros((k, v), np.float32)
    np.add.at(nkd, (docs, z), 1.0)
    np.add.at(nkv, (z, toks), 1.0)
    glob = RNG.integers(0, 4, (k, v)).astype(np.float32)
    return (torch.tensor(toks, device=dev), torch.tensor(docs, device=dev),
            _t(RNG.uniform(size=t), dev), torch.tensor(z, device=dev),
            _t(nkd, dev), _t(nkv, dev), _t(nkv.sum(1), dev),
            _t(glob, dev), _t(glob.sum(1), dev))


def _check_exact(args):
    """One kernel sweep against the plain version: the same bits."""
    t = args[0].shape[0]
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


@pytest.mark.parametrize("t,d,k,v", [(300, 20, 6, 150), (800, 30, 40, 300),
                                     (2000, 40, 100, 8192),
                                     # a 1,000-document gap of the main path
                                     (58000, 1000, 100, 8192)])
def test_cgs_sweep_exact_kernel_matches_plain(cuda, t, d, k, v):
    _check_exact(_exact_inputs(cuda, t, d, k, v))


def _runs(n, v):
    """n words in runs of 1-6 equal words (consecutive tokens share one)."""
    out = np.repeat(RNG.integers(0, v, n), RNG.integers(1, 7, n))
    return out[:n]


@pytest.mark.parametrize("case,t,d,k,v", [
    ("repeated_words", 3000, 50, 100, 500),   # the live-row patch
    ("repeated_words", 700, 10, 20, 3),       # V = 3: every row repeats
    ("revisits", 2000, 30, 40, 300),          # unsorted: documents revisit
    ("revisits", 500, 5, 1, 30),              # K = 1
    ("revisits", 600, 20, 1024, 200),         # K = 1024, 32 topics a lane
    ("alternating", 400, 2, 8, 50),           # a document change each token
])
def test_cgs_sweep_exact_kernel_on_every_stream(cuda, case, t, d, k, v):
    """The cached document row and the prefetched word rows: consecutive
    tokens of one word, a tiny vocabulary, an unsorted stream that comes
    back to a document, and K at both ends."""
    docs = toks = None
    if case == "repeated_words":
        toks = _runs(t, v)
    elif case == "revisits":
        docs = np.repeat(RNG.integers(0, d, t), RNG.integers(1, 40, t))[:t]
        toks = _runs(t, v)
    else:
        docs = np.arange(t) % d
        toks = _runs(t, v)
    args = _exact_inputs(cuda, t, d, k, v, docs, toks)
    if case != "repeated_words":
        assert np.any(np.diff(args[1].cpu().numpy()) < 0)
    _check_exact(args)


def test_cgs_sweep_exact_t_takes_the_transposed_layout(cuda):
    """The fit's (V, K) entry point gives what the (K, V) one does."""
    args = list(_exact_inputs(cuda, 900, 25, 30, 200))
    want = gibbs_ops.cgs_sweep_exact(*args, 0.5, 0.05)
    t_args = list(args)
    t_args[5], t_args[7] = args[5].t().contiguous(), args[7].t().contiguous()
    z, nkd, nkv_t, nk = gibbs_ops.cgs_sweep_exact_t(*t_args, 0.5, 0.05)
    for g, w in zip((z, nkd, nkv_t.t(), nk), want):
        assert torch.equal(g, w)


def test_gibbs_kernels_are_bitwise_repeatable(cuda):
    """Five calls of each kernel on one input give the same bits (n_kv
    sums integer counts by atomicAdd: exact in any order)."""
    blocked = _blocked_inputs(4, 300, 64, 100, 1000, cuda, "interleaved")
    exact = _exact_inputs(cuda, 3000, 50, 100, 500, toks=_runs(3000, 500))
    for fn, args in ((gibbs_ops.gibbs_sweep, blocked + (0.5,)),
                     (gibbs_ops.cgs_sweep_exact, exact + (0.5, 0.05))):
        first = fn(*args)
        for _ in range(4):
            for g, w in zip(fn(*args), first):
                assert torch.equal(g, w)


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
    big[5] = torch.zeros((2, 4, 1025), device=cuda)    # over 32 topics a lane
    big[6] = torch.ones((1025, 20), device=cuda)
    big[7] = torch.ones(1025, device=cuda)
    with pytest.raises(ValueError, match="32 topics a lane"):
        gibbs_ops.gibbs_sweep(*big, 0.5)
    with pytest.raises(ValueError):
        gibbs_ops.gibbs_sweep(*args[:4], args[4].cpu(), *args[5:], 0.5)


# ---------------------------------------------------------------------------
# attention (the LM serving path)
# ---------------------------------------------------------------------------

# (atol, rtol) of a kernel against its plain version run in float32 on
# the same inputs: the JAX kernel tests' 1e-5 in f32; in bf16 a limit with
# headroom over what rounding p and the output to bf16 costs (chip_smoke.py
# logs the atol each check uses) that fails the kernels with one KV tile
# or split skipped (tests/test_torch_attention.py)
ATTN_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (5e-3, 1e-2)}


def _n(shape, dev, dtype):
    return torch.tensor(RNG.normal(size=shape), dtype=torch.float32,
                        device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kvh,hd,causal,window", [
    (1, 200, 4, 2, 128, True, 0),     # qwen3's head shape, S % 64 != 0
    (2, 130, 4, 4, 64, True, 0),      # G = 1, hd 64
    (1, 96, 10, 2, 64, True, 0),      # G = 5
    (1, 200, 4, 2, 128, True, 50),    # window
    (2, 70, 4, 2, 32, False, 0),      # bidirectional
    (1, 128, 2, 1, 16, True, 0),      # the reduced configs' hd
    (1, 200, 8, 1, 256, True, 0),     # gemma-2b's heads: G = 8, hd 256
    (1, 150, 15, 5, 64, True, 0),     # smollm-360m's heads: G = 3
    (4, 2048, 16, 8, 128, True, 0),   # the serve path's shape
    (2, 1, 4, 2, 128, True, 0),       # S = 1
    (2, 15, 4, 2, 64, True, 0),       # under one 16-row mma tile
    (2, 17, 4, 2, 64, True, 0),       # across one 16-row mma tile
    (1, 256, 4, 2, 128, True, 37),    # a window that starts mid-tile
    (1, 130, 40, 8, 128, True, 0),    # qwen2.5-14b's heads: G = 5
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, s, h, kvh, hd,
                                              causal, window):
    q = _n((b, s, h, hd), cuda, dtype)
    k = _n((b, s, kvh, hd), cuda, dtype)
    v = _n((b, s, kvh, hd), cuda, dtype)
    before = flash_ops.flash_attention_launches
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention_launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_ref(q.float(), k.float(), v.float(),
                               causal=causal, window=window)
    atol, rtol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


def test_flash_attention_kernel_reads_strided_views(cuda):
    """q, k, v as views into one fused (B, S, H + 2 KVH, hd) projection."""
    b, s, h, kvh, hd = 2, 150, 4, 2, 128
    qkv = _n((b, s, h + 2 * kvh, hd), cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kvh], qkv[:, :, h + kvh:]
    assert not q.is_contiguous()
    got = flash_ops.flash_attention(q, k, v)
    want = flash_attention_ref(q.float(), k.float(), v.float())
    atol, rtol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


def test_flash_attention_kernel_is_bitwise_repeatable(cuda):
    b, s, h, kvh, hd = 2, 1000, 16, 8, 128
    q = _n((b, s, h, hd), cuda, torch.bfloat16)
    k = _n((b, s, kvh, hd), cuda, torch.bfloat16)
    v = _n((b, s, kvh, hd), cuda, torch.bfloat16)
    first = flash_ops.flash_attention(q, k, v)
    for _ in range(5):
        assert torch.equal(flash_ops.flash_attention(q, k, v), first)


def test_bf16_attention_wrappers_refuse_misaligned_views(cuda):
    """The bf16 kernels copy rows in 16-byte pieces: a view whose start or
    strides are not whole pieces raises ValueError, in float32 the same
    views run."""
    b, s, h, hd = 1, 40, 2, 64
    wide = _n((b, s, h, hd + 4), cuda, torch.bfloat16)[..., :hd]  # stride 68
    flat = _n((b * s * h * hd + 1,), cuda, torch.bfloat16)
    shifted = flat[1:].view(b, s, h, hd)                     # 2-byte offset
    ok = _n((b, s, h, hd), cuda, torch.bfloat16)
    for bad in (wide, shifted):
        with pytest.raises(ValueError):
            flash_ops.flash_attention(bad, ok, ok)
        with pytest.raises(ValueError):
            flash_ops.flash_attention(ok, bad, ok)
        with pytest.raises(ValueError):
            decode_ops.decode_attention(ok[:, :1], bad, ok, 3)
        with pytest.raises(ValueError):
            decode_ops.decode_attention(ok[:, :1], ok, bad, 3)
    wide32 = _n((b, s, h, hd + 4), cuda, torch.float32)[..., :hd]
    got = flash_ops.flash_attention(wide32, wide32, wide32)
    want = flash_attention_ref(wide32, wide32, wide32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kvh,hd,pos,window", [
    (2, 256, 4, 2, 128, 0, 0),        # first token
    (2, 256, 4, 2, 128, 255, 0),      # full cache (pos = S - 1)
    (1, 300, 10, 2, 64, 150, 0),      # G = 5, S not a multiple of a split
    (2, 200, 4, 4, 64, 199, 0),       # G = 1
    (1, 512, 4, 2, 128, 300, 64),     # window
    (1, 512, 4, 2, 128, 0, 64),       # window at pos 0
    (4, 2112, 16, 8, 128, 2100, 0),   # the serve path's shape
    (2, 300, 8, 1, 256, 299, 0),      # gemma-2b's heads: G * hd = 2,048
    (1, 300, 15, 5, 64, 250, 0),      # smollm-360m's heads: G = 3
    (2, 256, 4, 2, 128, 63, 0),       # pos = chunk - 1: one full split
    (2, 256, 4, 2, 128, 64, 0),       # pos = chunk: one key in split 1
    (1, 9000, 4, 2, 128, 8999, 0),    # long cache: 47 chunks of 3 tiles
    (1, 9000, 4, 2, 128, 5000, 0),    # the same, mid-chunk
    (1, 512, 4, 2, 128, 100, 64),     # a window across splits 0 and 1
    (1, 2112, 16, 8, 128, 2100, 0),   # one sequence: 33 chunks of 1 tile
    (1, 2112, 8, 1, 256, 2100, 0),    # gemma-2b's MQA, one sequence
])
def test_decode_attention_kernel_matches_plain(cuda, dtype, b, s, h, kvh,
                                               hd, pos, window):
    q = _n((b, 1, h, hd), cuda, dtype)
    kc = _n((b, s, kvh, hd), cuda, dtype)
    vc = _n((b, s, kvh, hd), cuda, dtype)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = decode_ops.decode_attention_launches
    got = decode_ops.decode_attention(q, kc, vc, p, window=window)
    torch.cuda.synchronize()
    assert decode_ops.decode_attention_launches == before + 1
    want = decode_attention_ref(q.float(), kc.float(), vc.float(), pos,
                                window=window)
    atol, rtol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


def test_decode_attention_kernel_is_bitwise_repeatable(cuda):
    b, s, h, kvh, hd = 4, 2112, 16, 8, 128
    q = _n((b, 1, h, hd), cuda, torch.bfloat16)
    kc = _n((b, s, kvh, hd), cuda, torch.bfloat16)
    vc = _n((b, s, kvh, hd), cuda, torch.bfloat16)
    p = torch.tensor(2100, dtype=torch.int32, device=cuda)
    first = decode_ops.decode_attention(q, kc, vc, p)
    for _ in range(5):
        assert torch.equal(decode_ops.decode_attention(q, kc, vc, p), first)


def test_attention_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.ones((1, 8, 2, 96), device=cuda)          # hd 96
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, q, q)
    q = torch.ones((1, 8, 2, 64), device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, q, q)
    q = torch.ones((1, 1, 2, 64), device=cuda)
    kc = torch.ones((1, 8, 1, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        decode_ops.decode_attention(q, kc, kc, 3)
    with pytest.raises(ValueError):                       # pos on the host
        decode_ops.decode_attention(q, kc.float(), kc.float(),
                                    torch.tensor(3, dtype=torch.int32))


def test_serve_path_launches_the_kernels_and_matches_the_cpu(cuda):
    """A reduced float32 qwen3 on the card: 1 flash launch per layer per
    prefill, 1 decode launch per layer per step, the logits of the CPU
    path (plain attention) at 1e-4, and a decode position outside the
    cache writes nothing."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model
    cfg = get_arch("qwen3-1.7b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    to_cpu = _tree_to(params, "cpu")
    toks = torch.tensor(RNG.integers(0, cfg.vocab_size, (2, 21)),
                        dtype=torch.int32)
    f0 = flash_ops.flash_attention_launches
    lg, caches = model.prefill(params, {"tokens": toks[:, :20].to(cuda)},
                               cache_len=24)
    assert flash_ops.flash_attention_launches == f0 + cfg.n_layers
    lg_c, caches_c = model.prefill(to_cpu, {"tokens": toks[:, :20]},
                                   cache_len=24)
    torch.testing.assert_close(lg.cpu(), lg_c, rtol=1e-4, atol=1e-4)
    d0 = decode_ops.decode_attention_launches
    lg, caches = model.decode_step(params, caches, toks[:, 20:].to(cuda),
                                   torch.tensor(20, dtype=torch.int32,
                                                device=cuda))
    assert decode_ops.decode_attention_launches == d0 + cfg.n_layers
    lg_c, caches_c = model.decode_step(to_cpu, caches_c, toks[:, 20:], 20)
    torch.testing.assert_close(lg.cpu(), lg_c, rtol=1e-4, atol=1e-4)
    before = [c["k"].clone() for c in caches]
    model.decode_step(params, caches, toks[:, 20:].to(cuda), 24)
    assert all(torch.equal(a, c["k"]) for a, c in zip(before, caches))
    out = generate(model, params, {"tokens": toks[:, :20]}, steps=4,
                   cache_len=24)
    out_c = generate(model, to_cpu, {"tokens": toks[:, :20]}, steps=4,
                     cache_len=24)
    assert torch.equal(out.cpu(), out_c)


# ---------------------------------------------------------------------------
# the sLSTM scan (the xLSTM serving path)
# ---------------------------------------------------------------------------

def _slstm_inputs(dev, b, s, h, hd, x_dtype=torch.float32,
                  r_dtype=torch.float32, nonzero=False):
    xpre = _n((b, s, 4, h, hd), dev, torch.float32).mul_(0.5).to(x_dtype)
    r = _n((h, hd, 4 * hd), dev, torch.float32).mul_(hd ** -0.5).to(r_dtype)
    if nonzero:
        st = (_n((b, h, hd), dev, torch.float32),
              torch.tensor(RNG.uniform(0.5, 2.0, (b, h, hd)),
                           dtype=torch.float32, device=dev),
              _n((b, h, hd), dev, torch.float32).mul_(0.5),
              _n((b, h, hd), dev, torch.float32))
    else:
        st = zero_state(b, h, hd, dev)
    return xpre, r, st


@pytest.mark.parametrize("b,s,h,hd,x_dtype,r_dtype,nonzero,tol", [
    (2, 32, 2, 16, torch.float32, torch.float32, False, 1e-5),
    (4, 64, 4, 32, torch.float32, torch.float32, False, 1e-5),
    (1, 48, 3, 8, torch.float32, torch.float32, False, 1e-5),
    (4, 1, 4, 512, torch.float32, torch.bfloat16, True, 1e-5),  # decode
    (4, 1, 4, 512, torch.bfloat16, torch.bfloat16, True, 1e-5),
    (3, 5, 2, 40, torch.float32, torch.float32, True, 1e-5),  # ragged CTA
    (6, 9, 2, 64, torch.float32, torch.bfloat16, False, 1e-5),  # B > 4
    # the served shape: 2,048 dependent steps, so 1e-4
    (4, 2048, 4, 512, torch.float32, torch.bfloat16, False, 1e-4),
    (4, 2048, 4, 512, torch.float32, torch.float32, False, 1e-4),
    (4, 2048, 4, 512, torch.bfloat16, torch.bfloat16, False, 1e-4),
])
def test_slstm_scan_kernel_matches_plain(cuda, b, s, h, hd, x_dtype,
                                         r_dtype, nonzero, tol):
    """h_out and the final state at ``tol``; a bf16 h_out to one bf16
    rounding (2^-7 relative) of the f32 value, which the final h holds."""
    xpre, r, st = _slstm_inputs(cuda, b, s, h, hd, x_dtype, r_dtype,
                                nonzero)
    before = slstm_ops.slstm_scan_launches
    got, got_st = slstm_ops.slstm_scan(xpre, r, *st)
    torch.cuda.synchronize()
    assert slstm_ops.slstm_scan_launches == before + 1
    assert got.dtype == x_dtype and got.shape == (b, s, h, hd)
    want, want_st = slstm_scan_ref(xpre, r, *st)
    h_tol = tol if x_dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=h_tol,
                               atol=h_tol)
    for g, w in zip(got_st, want_st):
        torch.testing.assert_close(g, w, rtol=tol, atol=tol)


def test_slstm_scan_kernel_reads_strided_views_and_repeats_bitwise(cuda):
    """xpre as a time-major array's transpose and as a slice of a wider
    projection; five calls give the same bits."""
    b, s, h, hd = 3, 40, 2, 64
    xt, r, _ = _slstm_inputs(cuda, s, b, h, hd)           # (S, B, ...)
    st = zero_state(b, h, hd, cuda)
    view = xt.transpose(0, 1)
    assert not view.is_contiguous()
    got, got_st = slstm_ops.slstm_scan(view, r, *st)
    want, want_st = slstm_scan_ref(view.contiguous(), r, *st)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    wide = _n((b, s, 5, h, hd), cuda, torch.float32)
    got2, _ = slstm_ops.slstm_scan(wide[:, :, 1:], r, *st)
    want2, _ = slstm_scan_ref(wide[:, :, 1:].contiguous(), r, *st)
    torch.testing.assert_close(got2, want2, rtol=1e-5, atol=1e-5)
    for _ in range(5):
        again, again_st = slstm_ops.slstm_scan(view, r, *st)
        assert torch.equal(again, got)
        assert all(torch.equal(a, g) for a, g in zip(again_st, got_st))


def test_slstm_scan_refuses_a_grid_that_cannot_be_resident(cuda):
    """16 heads of 512 with an f32 R take the cooperative route and ask
    for 512 CTAs of ~141 KB of shared memory, one per SM: more than the
    card holds at once.  The launch is refused with KernelError (never a
    plain fallback), and the next launch runs.  With a bf16 R the same
    shape takes the cluster route, whose 16 clusters run in waves."""
    xb, rb, stb = _slstm_inputs(cuda, 1, 2, 16, 512)
    assert slstm_ops.scan_plan(1, 2, 16, 512, rb.dtype).route == "coop"
    before = slstm_ops.slstm_scan_launches
    coop = slstm_ops.slstm_coop_launches
    with pytest.raises(KernelError):
        slstm_ops.slstm_scan(xb, rb, *stb)
    assert slstm_ops.slstm_scan_launches == before
    assert slstm_ops.slstm_coop_launches == coop
    rb16 = rb.bfloat16()
    assert slstm_ops.scan_plan(1, 2, 16, 512, rb16.dtype).route == "cluster"
    got, got_st = slstm_ops.slstm_scan(xb, rb16, *stb)
    want, want_st = slstm_scan_ref(xb, rb16, *stb)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for g, w in zip(got_st, want_st):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    xpre, r, st = _slstm_inputs(cuda, 4, 3, 4, 512)
    with pytest.raises(ValueError):                       # f64
        slstm_ops.slstm_scan(xpre.double(), r, *st)
    got, _ = slstm_ops.slstm_scan(xpre, r, *st)
    want, _ = slstm_scan_ref(xpre, r, *st)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _route_counts():
    return {r: getattr(slstm_ops, f"slstm_{r}_launches")
            for r in slstm_ops.ROUTES}


@pytest.mark.parametrize("b,s,h,hd,x_dtype,r_dtype,nonzero,route,ctas", [
    # bf16 R at hd = 512: H = 1, 4 and 16 (16 clusters run in waves)
    (2, 24, 1, 512, torch.float32, torch.bfloat16, True, "cluster", 16),
    (4, 24, 4, 512, torch.float32, torch.bfloat16, True, "cluster", 16),
    (2, 12, 16, 512, torch.bfloat16, torch.bfloat16, True, "cluster", 16),
    # batch rows from a nonzero state: 1 row; 2, 3 and 5 clusters of 4
    # rows a head (B = 6, 9, 17 at hd = 512 bf16); 2 chunks of 4 rows in
    # each of 2 clusters (B = 9 at hd = 128 and 256); 3 chunks in one
    # cluster (hd = 40)
    (1, 20, 2, 512, torch.float32, torch.bfloat16, True, "cluster", 16),
    (6, 20, 2, 512, torch.float32, torch.bfloat16, True, "cluster", 16),
    (9, 20, 2, 512, torch.float32, torch.bfloat16, True, "cluster", 16),
    (17, 6, 1, 512, torch.float32, torch.bfloat16, True, "cluster", 16),
    (9, 20, 2, 128, torch.float32, torch.bfloat16, True, "cluster", 1),
    (9, 20, 2, 256, torch.float32, torch.bfloat16, True, "cluster", 4),
    (9, 20, 2, 40, torch.float32, torch.bfloat16, True, "cluster", 1),
    # P = 1, 2, 4, 8 and 16 by hd (bf16 R)
    (2, 16, 2, 128, torch.float32, torch.bfloat16, True, "cluster", 1),
    (3, 16, 2, 192, torch.float32, torch.bfloat16, True, "cluster", 2),
    (3, 16, 2, 256, torch.float32, torch.bfloat16, True, "cluster", 4),
    (5, 16, 3, 384, torch.float32, torch.bfloat16, True, "cluster", 8),
    (3, 16, 2, 448, torch.bfloat16, torch.bfloat16, True, "cluster", 16),
    # f32 R at S >= 2 takes the cooperative route at every hd
    (9, 20, 2, 40, torch.float32, torch.float32, True, "coop", 3),
    (4, 16, 2, 64, torch.float32, torch.float32, True, "coop", 4),
    (3, 16, 2, 128, torch.float32, torch.float32, True, "coop", 8),
    (3, 16, 2, 256, torch.float32, torch.float32, True, "coop", 16),
    # the step route (S = 1) at B = 1 and 8, both dtypes of R
    (1, 1, 4, 512, torch.float32, torch.bfloat16, True, "step", 32),
    (8, 1, 4, 512, torch.bfloat16, torch.bfloat16, True, "step", 32),
    (8, 1, 4, 512, torch.float32, torch.float32, True, "step", 64),
    (3, 1, 3, 40, torch.float32, torch.float32, True, "step", 5),
    # the cooperative route: f32 R of 512
    (2, 16, 2, 512, torch.float32, torch.float32, True, "coop", 32),
])
def test_slstm_scan_takes_the_planned_route_and_matches_plain(
        cuda, b, s, h, hd, x_dtype, r_dtype, nonzero, route, ctas):
    """Each case takes the route and CTA count ``scan_plan`` names (its
    counter and no other moves) and holds the plain version at 1e-5 (h
    in bf16 to one bf16 rounding, 2^-7)."""
    plan = slstm_ops.scan_plan(b, s, h, hd, r_dtype)
    assert (plan.route, plan.ctas) == (route, ctas)
    xpre, r, st = _slstm_inputs(cuda, b, s, h, hd, x_dtype, r_dtype,
                                nonzero)
    before = _route_counts()
    got, got_st = slstm_ops.slstm_scan(xpre, r, *st)
    torch.cuda.synchronize()
    after = _route_counts()
    assert after == {k: v + (k == route) for k, v in before.items()}
    want, want_st = slstm_scan_ref(xpre, r, *st)
    h_tol = 1e-5 if x_dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=h_tol,
                               atol=h_tol)
    for g, w in zip(got_st, want_st):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    if route == "cluster":
        key = (str(x_dtype), plan.ctas, plan.units, plan.rows, plan.smem)
        assert slstm_ops.cluster_occupancy[key] >= 1


@pytest.mark.parametrize("b,s,h,hd,r_dtype,route", [
    (4, 64, 4, 512, torch.bfloat16, "cluster"),
    (9, 16, 2, 512, torch.bfloat16, "cluster"),
    (4, 1, 4, 512, torch.bfloat16, "step"),
    (4, 16, 2, 512, torch.float32, "coop"),
])
def test_slstm_scan_gives_the_same_bits_on_every_route(cuda, b, s, h, hd,
                                                       r_dtype, route):
    assert slstm_ops.scan_plan(b, s, h, hd, r_dtype).route == route
    xpre, r, st = _slstm_inputs(cuda, b, s, h, hd, torch.bfloat16, r_dtype,
                                True)
    got, got_st = slstm_ops.slstm_scan(xpre, r, *st)
    for _ in range(5):
        again, again_st = slstm_ops.slstm_scan(xpre, r, *st)
        assert torch.equal(again, got)
        assert all(torch.equal(a, g) for a, g in zip(again_st, got_st))


def test_xlstm_serve_path_launches_the_kernel_and_matches_the_cpu(cuda):
    """A reduced float32 xLSTM (two pattern groups and an "m" tail) on the
    card: one sLSTM launch per "s" layer per prefill and per decode step,
    and the logits of the CPU path (the plain scan) at 1e-4."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_arch("xlstm-1.3b").reduced(), n_layers=7)
    n_s = cfg.layer_kinds().count("s")
    assert n_s == 2
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    to_cpu = _tree_to(params, "cpu")
    toks = torch.tensor(RNG.integers(0, cfg.vocab_size, (2, 21)),
                        dtype=torch.int32)
    k0 = slstm_ops.slstm_scan_launches
    lg, caches = model.prefill(params, {"tokens": toks[:, :20].to(cuda)})
    assert slstm_ops.slstm_scan_launches == k0 + n_s
    lg_c, caches_c = model.prefill(to_cpu, {"tokens": toks[:, :20]})
    torch.testing.assert_close(lg.cpu(), lg_c, rtol=1e-4, atol=1e-4)
    for c, c_c in zip(caches, caches_c):
        for name in c:
            torch.testing.assert_close(c[name].cpu(), c_c[name], rtol=1e-4,
                                       atol=1e-4)
    k0 = slstm_ops.slstm_scan_launches
    lg, caches = model.decode_step(params, caches, toks[:, 20:].to(cuda), 20)
    assert slstm_ops.slstm_scan_launches == k0 + n_s
    lg_c, _ = model.decode_step(to_cpu, caches_c, toks[:, 20:], 20)
    torch.testing.assert_close(lg.cpu(), lg_c, rtol=1e-4, atol=1e-4)
    out = generate(model, params, {"tokens": toks[:, :20]}, steps=4,
                   cache_len=24)
    out_c = generate(model, to_cpu, {"tokens": toks[:, :20]}, steps=4,
                     cache_len=24)
    assert torch.equal(out.cpu(), out_c)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _service_case():
    from repro_torch.configs.lda_default import LDAConfig
    from repro_torch.data.corpus import make_corpus
    cfg = LDAConfig(n_topics=6, vocab_size=150, alpha=0.5, eta=0.05,
                    max_iters=6, e_step_iters=5, gibbs_sweeps=6)
    corpus, _ = make_corpus(400, 150, 6, mean_doc_len=30, seed=3)
    return corpus, cfg


def test_service_answers_concurrent_tenants_through_the_kernels(cuda):
    """A CUDA service: a covered query alone (the single merge), then
    three tenants at once with covered and gapped specs (fused groups: the
    ragged merge, gaps on the E-step kernel)."""
    import threading
    from repro_torch.api import Interval, QuerySpec
    from repro_torch.serve import MLegoService
    corpus, cfg = _service_case()
    with MLegoService(corpus.subset(0.0, 300.0), cfg, backend="device",
                      device="cuda", window_s=0.2, max_width=16) as svc:
        for i in range(3):
            svc.train_range(100.0 * i, 100.0 * (i + 1))
        before = (merge_ops.merge_topics_launches,
                  merge_ops.merge_topics_ragged_launches, estep_ops.launches)
        alone = svc.submit(QuerySpec(sigma=Interval(0.0, 300.0)),
                           tenant="solo").result(timeout=120)
        specs = [QuerySpec(sigma=Interval(0.0, 200.0)),
                 QuerySpec(sigma=Interval(50.0, 250.0), alpha=0.0,
                           materialize="volatile"),
                 QuerySpec(sigma=Interval(100.0, 300.0))]
        barrier = threading.Barrier(3)
        futs = []

        def client(tenant):
            barrier.wait(timeout=60)
            futs.extend(svc.submit(s, tenant=tenant) for s in specs)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in ("ana", "bob", "cy")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        reps = [alone] + [f.result(timeout=120) for f in futs]
        torch.cuda.synchronize()
        report = svc.report()
    grew = (merge_ops.merge_topics_launches - before[0],
            merge_ops.merge_topics_ragged_launches - before[1],
            estep_ops.launches - before[2])
    assert all(g > 0 for g in grew), grew
    assert report.max_coalesce_width >= 2 and report.errors == 0
    assert any(r.n_trained_tokens > 0 for r in reps)
    for r in reps:
        assert r.backend == "device" and r.fallback_from is None
        assert np.isfinite(r.beta).all()
        np.testing.assert_allclose(r.beta.sum(1), 1.0, rtol=1e-5)


def test_ingest_pipeline_builds_slices_on_the_estep_kernel(cuda):
    from repro_torch.api import Interval, QuerySpec
    from repro_torch.serve import MLegoService
    corpus, cfg = _service_case()
    with MLegoService(corpus.subset(0.0, 200.0), cfg, backend="device",
                      device="cuda", window_s=0.0) as svc:
        pipe = svc.attach_ingest(slice_width=50.0, start=200.0)
        assert pipe.device == svc.backend.device
        before = estep_ops.launches
        svc.ingest(corpus.subset(200.0, 300.0))
        svc.ingest(corpus.subset(300.0, 400.0))
        assert pipe.flush(timeout=120)
        pipe.close()
        rep = pipe.report()
        launched = estep_ops.launches - before
        q = svc.submit(QuerySpec(sigma=Interval(200.0, 400.0))).result(
            timeout=120)
    assert rep.slices_built == 4 and rep.build_errors == 0
    assert launched == 4 * 2 * cfg.max_iters
    assert q.n_trained_tokens == 0 and np.isfinite(q.beta).all()
