"""VB E-step and ``vb_fit`` of the PyTorch port against the JAX package.

Inputs are made from a NumPy seed and fed to both packages.  The JAX
E-step runs its Pallas kernel in interpret mode and its jnp reference;
the port's wrapper runs its plain version on CPU tensors (the kernel's
arithmetic over the CSR nonzeros, including the series digamma).
Tolerance 2e-4, as the JAX package's own E-step test uses.  The CSR
build (``doc_term_csr``) must give back x exactly, the build from a
window's tokens (``doc_term_csr_from_tokens``) the same CSR, and the
kernel's plan
(``estep_plan``) is checked here too: the kernel itself runs only on the
card (``tests/test_torch_cuda.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.vb import vb_estep as jax_core_estep  # noqa: E402
from repro.core.vb import vb_fit as jax_vb_fit  # noqa: E402
from repro.data.corpus import doc_term_matrix  # noqa: E402
from repro.kernels.vb_estep.ops import vb_estep as jax_kernel_estep  # noqa: E402
from repro.kernels.vb_estep.ref import vb_estep_ref as jax_ref  # noqa: E402
from repro_torch.configs.lda_default import LDAConfig as TorchCfg  # noqa: E402
from repro_torch.core import vb as tvb  # noqa: E402
from repro_torch.kernels.vb_estep import ops  # noqa: E402
from repro_torch.kernels.vb_estep.ref import (  # noqa: E402
    digamma_series, vb_estep_csr_ref, vb_estep_ref)

try:
    from hypothesis import given, settings, strategies as hst
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - optional dependency
    HAVE_HYPOTHESIS = False

TOL = dict(rtol=2e-4, atol=2e-4)
RNG = np.random.default_rng(42)
ESTEP_SHAPES = [(32, 128, 16), (65, 200, 100), (128, 384, 128), (8, 64, 10),
                # D not a multiple of the doc block: a ragged last block
                # must add nothing
                (135, 150, 6), (300, 192, 12)]


def _inputs(d, v, k):
    x = RNG.poisson(0.5, (d, v)).astype(np.float32)
    eeb = RNG.gamma(1.0, 1.0, (k, v)).astype(np.float32)
    eeb = (eeb / eeb.sum(1, keepdims=True)).astype(np.float32)
    g0 = np.ones((d, k), np.float32)
    return x, eeb, g0


@pytest.mark.parametrize("d,v,k", ESTEP_SHAPES)
def test_vb_estep_matches_jax(d, v, k):
    x, eeb, g0 = _inputs(d, v, k)
    g, s = ops.vb_estep(torch.from_numpy(x), torch.from_numpy(eeb),
                        torch.from_numpy(g0), 0.5, 8)
    assert g.shape == (d, k) and s.shape == (k, v)
    gk, sk = jax_kernel_estep(jnp.asarray(x), jnp.asarray(eeb),
                              jnp.asarray(g0), 0.5, 8, interpret=True)
    gr, sr = jax_ref(jnp.asarray(x), jnp.asarray(eeb), jnp.asarray(g0),
                     0.5, 8)
    for want_g, want_s in ((gk, sk), (gr, sr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_core_vb_estep_matches_jax(use_kernel):
    x, eeb, g0 = _inputs(40, 96, 7)
    g, s = tvb.vb_estep(torch.from_numpy(x), torch.from_numpy(eeb),
                        torch.from_numpy(g0), 0.5, 8, use_kernel=use_kernel)
    gj, sj = jax_core_estep(jnp.asarray(x), jnp.asarray(eeb),
                            jnp.asarray(g0), 0.5, 8)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_core_vb_estep_refuses_tensors_off_the_cpu(use_kernel):
    """No device tensor reaches a plain version: off the CPU the plain
    path raises, and the kernel route takes only CUDA tensors."""
    x = torch.ones((4, 8), device="meta")
    with pytest.raises(ValueError):
        tvb.vb_estep(x, torch.ones((3, 8), device="meta"),
                     torch.ones((4, 3), device="meta"), 0.5, 2,
                     use_kernel=use_kernel)


def test_digamma_series_matches_library():
    x = torch.from_numpy(RNG.uniform(0.01, 50.0, 2000).astype(np.float64))
    np.testing.assert_allclose(digamma_series(x).numpy(),
                               torch.special.digamma(x).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_vb_fit_matches_jax_with_shared_lam0(small_cfg, small_corpus,
                                             use_kernel):
    """Same corpus, same λ0 (drawn by JAX from the same PRNGKey that
    JAX's vb_fit draws it from) — the whole fit agrees at 2e-4."""
    corpus, _ = small_corpus
    x = doc_term_matrix(corpus, 0, 120)
    key = jax.random.PRNGKey(3)
    lam0 = np.asarray(jax.random.gamma(
        key, 100.0, (small_cfg.n_topics, small_cfg.vocab_size),
        jnp.float32) * 0.01)
    want = np.asarray(jax_vb_fit(jnp.asarray(x), key, small_cfg))
    tcfg = TorchCfg(**{f: getattr(small_cfg, f) for f in
                       small_cfg.__dataclass_fields__})
    gen = torch.Generator().manual_seed(0)
    got = tvb.vb_fit(x, gen, tcfg, use_kernel=use_kernel, lam0=lam0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_vb_fit_draws_lam0_from_the_generator(small_cfg):
    tcfg = TorchCfg(n_topics=4, vocab_size=30, max_iters=0)
    x = np.ones((5, 30), np.float32)
    a = tvb.vb_fit(x, torch.Generator().manual_seed(1), tcfg)
    b = tvb.vb_fit(x, torch.Generator().manual_seed(1), tcfg)
    c = tvb.vb_fit(x, torch.Generator().manual_seed(2), tcfg)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # Gamma(100) * 0.01 has mean 1 and standard deviation 0.1
    assert abs(float(a.mean()) - 1.0) < 0.05
    with pytest.raises(ValueError):
        tvb.vb_fit(x, torch.Generator(), tcfg, lam0=np.ones((3, 30)))


def test_cpu_tensors_never_count_a_kernel_launch():
    before = ops.launches
    x, eeb, g0 = _inputs(8, 16, 3)
    ops.vb_estep(torch.from_numpy(x), torch.from_numpy(eeb),
                 torch.from_numpy(g0), 0.5, 2)
    assert ops.launches == before


CSR_FIELDS = ("indptr", "indices", "values", "rows", "col_ptr", "perm")


def _tokens_of(x, rng, within_docs=True):
    """(doc_ids, tokens) int32 of the counts x: each (doc, term) repeated
    by its count, shuffled within each document as a corpus's tokens
    are, or across the whole window."""
    d, w = np.nonzero(x)
    n = x[d, w].astype(np.int64)
    docs, terms = np.repeat(d, n), np.repeat(w, n)
    order = (np.lexsort((rng.permutation(len(docs)), docs)) if within_docs
             else rng.permutation(len(docs)))
    return (torch.from_numpy(docs[order].astype(np.int32)),
            torch.from_numpy(terms[order].astype(np.int32)))


def _assert_same_csr(got, want):
    assert got.shape == want.shape and got.max_row == want.max_row
    for f in CSR_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


def _check_csr(x, within_docs=True):
    """doc_term_csr(x) gives back x exactly, rows in (d, v) order, and a
    column view whose perm lists each column's entries in document order;
    doc_term_csr_from_tokens of x's tokens is the same CSR, field for
    field."""
    csr = ops.doc_term_csr(torch.from_numpy(x))
    doc_ids, tokens = _tokens_of(x, np.random.default_rng(x.size),
                                 within_docs)
    _assert_same_csr(ops.doc_term_csr_from_tokens(doc_ids, tokens,
                                                  *x.shape), csr)
    d, v = x.shape
    nz = np.nonzero(x)
    assert csr.shape == (d, v) and csr.nnz == len(nz[0])
    for t in (csr.indptr, csr.indices, csr.rows, csr.col_ptr, csr.perm):
        assert t.dtype == torch.int32
    np.testing.assert_array_equal(csr.indptr.numpy(),
                                  np.concatenate([[0], np.cumsum(
                                      (x != 0).sum(1))]))
    np.testing.assert_array_equal(csr.rows.numpy(), nz[0])
    np.testing.assert_array_equal(csr.indices.numpy(), nz[1])
    assert csr.values.dtype == torch.float32
    back = np.zeros_like(x)
    back[csr.rows.numpy(), csr.indices.numpy()] = csr.values.numpy()
    np.testing.assert_array_equal(back, x)
    perm = csr.perm.numpy()
    np.testing.assert_array_equal(np.sort(perm), np.arange(csr.nnz))
    cols, docs = csr.indices.numpy()[perm], csr.rows.numpy()[perm]
    order = np.lexsort((docs, cols))
    np.testing.assert_array_equal(order, np.arange(csr.nnz))
    np.testing.assert_array_equal(csr.col_ptr.numpy(), np.concatenate(
        [[0], np.cumsum(np.bincount(cols, minlength=v))]))
    assert csr.max_row == int((x != 0).sum(1).max(initial=0))
    return csr


@pytest.mark.parametrize("d,v", [(7, 50), (1, 1), (5, 3), (40, 300),
                                 # a window of one term, a long thin one,
                                 # and one with more documents than terms
                                 (9, 1), (3, 2000), (120, 6)])
def test_doc_term_csr_gives_back_x(d, v):
    """Empty rows and columns, one dense row, and repeated counts."""
    x = RNG.poisson(0.3, (d, v)).astype(np.float32)
    x[d // 2] = 0.0
    x[:, v // 2] = 0.0
    x[-1] = RNG.integers(1, 4, v)
    _check_csr(x)
    _check_csr(np.zeros((d, v), np.float32))


def test_csr_from_no_tokens_is_empty():
    """A window with no tokens (or no documents): nnz 0, max_row 0, and
    every offset 0."""
    none = torch.zeros((0,), dtype=torch.int32)
    for d, v in ((4, 7), (0, 7)):
        csr = ops.doc_term_csr_from_tokens(none, none, d, v)
        _assert_same_csr(csr, ops.doc_term_csr(torch.zeros((d, v))))
        assert csr.nnz == 0 and csr.max_row == 0
        assert not csr.indptr.any() and not csr.col_ptr.any()


@pytest.mark.parametrize("doc,term", [(0, 5), (1, -1), (3, 0), (-1, 2)])
def test_csr_from_tokens_refuses_an_out_of_range_token(doc, term):
    """A term outside [0, V) or a document outside [0, n_docs) raises, as
    the dense build's ``np.add.at`` raises on it (there IndexError)."""
    doc_ids = torch.tensor([0, 2, doc], dtype=torch.int32)
    tokens = torch.tensor([1, 4, term], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        ops.doc_term_csr_from_tokens(doc_ids, tokens, 3, 5)
    with pytest.raises(ValueError):
        ops.doc_term_csr_from_tokens(doc_ids, tokens[:2], 3, 5)


if HAVE_HYPOTHESIS:
    @settings(max_examples=40, deadline=None)
    @given(d=hst.integers(1, 30), v=hst.integers(1, 60),
           density=hst.floats(0.0, 1.0), seed=hst.integers(0, 2 ** 16),
           dense_row=hst.booleans())
    def test_doc_term_csr_gives_back_x_at_random_shapes(d, v, density, seed,
                                                       dense_row):
        rng = np.random.default_rng(seed)
        x = (rng.uniform(size=(d, v)) < density) * rng.integers(1, 5, (d, v))
        x = x.astype(np.float32)
        if dense_row:
            x[rng.integers(d)] = rng.integers(1, 5, v)
        _check_csr(x)

    @settings(max_examples=40, deadline=None)
    @given(d=hst.integers(0, 30), v=hst.integers(1, 60),
           density=hst.floats(0.0, 1.0), seed=hst.integers(0, 2 ** 16),
           dense_row=hst.booleans())
    def test_csr_from_tokens_in_any_order_at_random_shapes(d, v, density,
                                                           seed, dense_row):
        """The token build does not rely on a corpus's order: tokens
        shuffled across documents give the same CSR (no documents, all
        zeros and a dense row included)."""
        rng = np.random.default_rng(seed)
        x = (rng.uniform(size=(d, v)) < density) * rng.integers(1, 5, (d, v))
        x = x.astype(np.float32)
        if dense_row and d:
            x[rng.integers(d)] = rng.integers(1, 5, v)
        _check_csr(x, within_docs=False)


@pytest.mark.parametrize("d,v,k", ESTEP_SHAPES)
def test_vb_estep_csr_ref_matches_jax(d, v, k):
    """The plain CSR E-step against the JAX package's jnp reference and
    its Pallas kernel in interpret mode, on the same numpy inputs."""
    x, eeb, g0 = _inputs(d, v, k)
    x[d // 3] = 0.0                       # a document with no words
    csr = ops.doc_term_csr(torch.from_numpy(x))
    g, s = vb_estep_csr_ref(csr, torch.from_numpy(eeb), torch.from_numpy(g0),
                            0.5, 8)
    assert g.shape == (d, k) and s.shape == (k, v)
    gk, sk = jax_kernel_estep(jnp.asarray(x), jnp.asarray(eeb),
                              jnp.asarray(g0), 0.5, 8, interpret=True)
    gr, sr = jax_ref(jnp.asarray(x), jnp.asarray(eeb), jnp.asarray(g0),
                     0.5, 8)
    for want_g, want_s in ((gk, sk), (gr, sr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **TOL)
    # and the port's own dense plain version, the card tests' yardstick
    gd, sd = vb_estep_ref(torch.from_numpy(x), torch.from_numpy(eeb),
                          torch.from_numpy(g0), 0.5, 8)
    np.testing.assert_allclose(g.numpy(), gd.numpy(), **TOL)
    np.testing.assert_allclose(s.numpy(), sd.numpy(), **TOL)


@pytest.mark.parametrize("n_iters", [0, 1])
def test_vb_estep_csr_ref_few_iterations(n_iters):
    x, eeb, g0 = _inputs(12, 40, 5)
    csr = ops.doc_term_csr(torch.from_numpy(x))
    g, s = vb_estep_csr_ref(csr, torch.from_numpy(eeb), torch.from_numpy(g0),
                            0.5, n_iters)
    gr, sr = jax_ref(jnp.asarray(x), jnp.asarray(eeb), jnp.asarray(g0),
                     0.5, n_iters)
    np.testing.assert_allclose(g.numpy(), np.asarray(gr), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), **TOL)


def test_vb_fit_builds_the_csr_once_per_fit(small_cfg, small_corpus,
                                            monkeypatch):
    """The conversion (and its one synchronisation) stays out of the
    per-call path: one build, then one CSR E-step per outer iteration."""
    corpus, _ = small_corpus
    x = doc_term_matrix(corpus, 0, 60)
    builds, calls = [], []
    real_build, real_estep = ops.doc_term_csr, ops.vb_estep_csr

    def build(t):
        builds.append(t.shape)
        return real_build(t)

    def estep(csr, *a, **kw):
        calls.append(csr)
        return real_estep(csr, *a, **kw)
    monkeypatch.setattr(ops, "doc_term_csr", build)
    monkeypatch.setattr(ops, "vb_estep_csr", estep)
    tcfg = TorchCfg(**{f: getattr(small_cfg, f) for f in
                       small_cfg.__dataclass_fields__})
    tvb.vb_fit(x, torch.Generator().manual_seed(0), tcfg, use_kernel=True)
    assert builds == [x.shape]
    assert len(calls) == tcfg.max_iters and all(c is calls[0] for c in calls)


def test_vb_fit_on_a_csr_builds_nothing(small_cfg, small_corpus,
                                       monkeypatch):
    """Handed a CSR, ``vb_fit`` uploads and builds nothing and passes
    that same object to every E-step call; λ is the dense route's to the
    bit.  Without the kernel it refuses the CSR."""
    corpus, _ = small_corpus
    sub = corpus.subset(corpus.attr[0], corpus.attr[60])
    csr = ops.doc_term_csr_from_tokens(torch.from_numpy(sub.doc_ids),
                                       torch.from_numpy(sub.tokens),
                                       sub.n_docs, sub.vocab_size)
    builds, calls = [], []
    real_estep = ops.vb_estep_csr

    def estep(c, *a, **kw):
        calls.append(c)
        return real_estep(c, *a, **kw)
    for name in ("doc_term_csr", "doc_term_csr_from_tokens"):
        monkeypatch.setattr(ops, name, lambda *a, **kw: builds.append(a))
    monkeypatch.setattr(ops, "vb_estep_csr", estep)
    tcfg = TorchCfg(**{f: getattr(small_cfg, f) for f in
                       small_cfg.__dataclass_fields__})
    lam = tvb.vb_fit(csr, torch.Generator().manual_seed(0), tcfg,
                     use_kernel=True)
    assert builds == []
    assert len(calls) == tcfg.max_iters and all(c is csr for c in calls)
    monkeypatch.undo()
    want = tvb.vb_fit(doc_term_matrix(corpus, 0, 60),
                      torch.Generator().manual_seed(0), tcfg, use_kernel=True)
    assert torch.equal(lam, want)
    with pytest.raises(ValueError, match="use_kernel"):
        tvb.vb_fit(csr, torch.Generator(), tcfg)


@pytest.mark.parametrize("k,max_row", [(100, 88), (100, 1000), (256, 137),
                                       (6, 76), (1, 1), (256, 10 ** 6)])
def test_estep_plan_fits_shared_memory(k, max_row):
    """The kernel's row budget: every row of the longest document where
    it fits, else chunks; a CTA's shared memory within Hopper's 227 KB,
    and at the main path's shape (K = 100, rows <= 88) six CTAs an SM."""
    rows, smem = ops.estep_plan(k, max_row)
    assert 1 <= rows <= max_row
    assert smem <= 232448
    assert rows * 4 * k <= ops.DOC_ROW_BYTES or rows == 1
    if (k, max_row) == (100, 88):
        assert rows == 88 and 6 * (smem + 1024) <= 233472
    if max_row > rows:                     # the chunked path: the budget
        # is full (a row's stride is under K + 8 floats)
        assert (rows + 1) * 4 * (k + 8) > ops.DOC_ROW_BYTES


def test_dense_wrapper_runs_the_csr_path():
    """``vb_estep`` converts x and calls ``vb_estep_csr``: the same numbers
    as the CSR plain version on a prebuilt CSR."""
    x, eeb, g0 = _inputs(20, 70, 9)
    args = (torch.from_numpy(eeb), torch.from_numpy(g0), 0.5, 6)
    g1, s1 = ops.vb_estep(torch.from_numpy(x), *args)
    g2, s2 = ops.vb_estep_csr(ops.doc_term_csr(torch.from_numpy(x)), *args)
    assert torch.equal(g1, g2) and torch.equal(s1, s2)
    with pytest.raises(ValueError):
        ops.vb_estep_csr(ops.doc_term_csr(torch.from_numpy(x)),
                         torch.from_numpy(eeb[:, :10]), args[1], 0.5, 6)
