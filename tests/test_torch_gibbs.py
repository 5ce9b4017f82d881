"""Gibbs samplers of the PyTorch port against the JAX package.

The config and corpus of ``tests/test_gibbs_blocked.py`` (K = 8,
V = 300, 240 documents, 10 sweeps).  The JAX side is its jnp path
(``gibbs_sweep_ref``, ``cgs_fit_blocked(use_kernel=False)`` and the
exact ``cgs_fit``); the port runs on CPU tensors, through each kernel's
plain version.  With the same draws — JAX's own z0 and uniforms, derived
from the same ``PRNGKey`` splits as ``src/repro/core/gibbs.py`` — the
samplers agree exactly: z, n_kd and ΔN_kv are equal, not close.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.lda_default import LDAConfig as JaxCfg  # noqa: E402
from repro.core import gibbs as jgibbs  # noqa: E402
from repro.data.corpus import make_corpus as jax_make_corpus  # noqa: E402
from repro.kernels.gibbs_sweep.ref import gibbs_sweep_ref as jax_sweep  # noqa: E402
from repro_torch.configs.lda_default import LDAConfig  # noqa: E402
from repro_torch.core import gibbs as tgibbs  # noqa: E402
from repro_torch.core.lda import (  # noqa: E402
    greedy_topic_overlap,
    log_predictive_probability,
    topics_from_gs,
)
from repro_torch.data.corpus import (  # noqa: E402
    doc_term_matrix,
    make_corpus,
    train_test_split,
)
from repro_torch.kernels.gibbs_sweep import ops  # noqa: E402

FIELDS = dict(n_topics=8, vocab_size=300, alpha=0.5, eta=0.05,
              gibbs_sweeps=10)
CFG = LDAConfig(**FIELDS)
JCFG = JaxCfg(**FIELDS)
K, V, SWEEPS = 8, 300, 10


@pytest.fixture(scope="module")
def corpus():
    jc, _ = jax_make_corpus(240, V, K, mean_doc_len=40, seed=0)
    tc, _ = make_corpus(240, V, K, mean_doc_len=40, seed=0)
    np.testing.assert_array_equal(jc.tokens, tc.tokens)
    np.testing.assert_array_equal(jc.doc_ids, tc.doc_ids)
    return tc


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _integer_prior(seed):
    return np.random.default_rng(seed).integers(0, 6, (K, V)) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_docs", [32, 48, 64, 1000])
def test_blocked_layout_matches_jax(corpus, block_docs):
    got = tgibbs.blocked_layout(corpus.tokens, corpus.doc_ids,
                                corpus.n_docs, block_docs)
    want = jgibbs.blocked_layout(corpus.tokens, corpus.doc_ids,
                                 corpus.n_docs, block_docs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# one blocked sweep
# ---------------------------------------------------------------------------

def _sweep_inputs(corpus, seed, with_prior, block_docs=48):
    """A sweep's state from the layout (its last block is ragged), with
    the snapshot formed as ``_blocked_sweeps`` forms it."""
    rng = np.random.default_rng(seed)
    words, ldoc, mask = jgibbs.blocked_layout(
        corpus.tokens, corpus.doc_ids, corpus.n_docs, block_docs)
    b, t = words.shape
    z = rng.integers(0, K, (b, t)).astype(np.int32)
    nkd = np.zeros((b, block_docs, K), np.float32)
    for i in range(b):
        np.add.at(nkd[i], (ldoc[i], z[i]), mask[i])
    nkv = np.zeros((K, V), np.float32)
    np.add.at(nkv, (z.ravel(), words.ravel()), mask.ravel())
    glob = _integer_prior(seed + 100) if with_prior \
        else np.zeros((K, V), np.float32)
    prior = nkv + glob + np.float32(CFG.eta)
    prior_k = (nkv.sum(1) + glob.sum(1) + np.float32(V * CFG.eta)) \
        .astype(np.float32)
    u = rng.uniform(size=(b, t)).astype(np.float32)
    return words, ldoc, mask, u, z, nkd, prior.astype(np.float32), prior_k


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_prior", [False, True])
def test_gibbs_sweep_matches_jax(corpus, seed, with_prior):
    args = _sweep_inputs(corpus, seed, with_prior)
    assert args[2][-1].min() == 0.0, "the last block must be ragged"
    jz, jnkd, jnkv = jax_sweep(*map(jnp.asarray, args), CFG.alpha)
    tz, tnkd, tnkv = ops.gibbs_sweep(*map(torch.from_numpy, args), CFG.alpha)
    assert tz.dtype == torch.int32
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tnkd.numpy(), np.asarray(jnkd))
    np.testing.assert_array_equal(tnkv.numpy(), np.asarray(jnkv))
    # pad slots keep their topic; the counts are those of the real tokens
    pad = args[2] == 0
    np.testing.assert_array_equal(tz.numpy()[pad], args[4][pad])
    assert float(tnkv.sum()) == corpus.n_tokens


def _per_token_to_layout(x, corpus, block_docs):
    """Scatter a per-token array into ``blocked_layout``'s (B, T) slots
    (block b's first slots hold its documents' tokens in stream order)."""
    words, _, mask = jgibbs.blocked_layout(corpus.tokens, corpus.doc_ids,
                                          corpus.n_docs, block_docs)
    out = np.zeros(words.shape, x.dtype)
    out[mask > 0] = x
    return out


@pytest.mark.parametrize("with_prior", [False, True])
def test_documents_are_independent_chains(corpus, with_prior):
    """A blocked sweep's draws do not depend on how documents are
    grouped into blocks: with the same per-token z and u, JAX's
    ``gibbs_sweep_ref`` gives the same per-token z and n_kv laid out
    with 64 documents a block and with one.  So the kernel may run one
    chain per document.  The port's plain version gives the same."""
    rng = np.random.default_rng(7)
    n = corpus.n_tokens
    z_tok = rng.integers(0, K, n).astype(np.int32)
    u_tok = rng.uniform(size=n).astype(np.float32)
    nkv = np.zeros((K, V), np.float32)
    np.add.at(nkv, (z_tok, corpus.tokens), 1.0)
    glob = _integer_prior(9) if with_prior else np.zeros((K, V), np.float32)
    prior = (nkv + glob + np.float32(CFG.eta)).astype(np.float32)
    prior_k = (nkv.sum(1) + glob.sum(1) + np.float32(V * CFG.eta)) \
        .astype(np.float32)
    results = {}
    for bd in (64, 1):
        words, ldoc, mask = jgibbs.blocked_layout(
            corpus.tokens, corpus.doc_ids, corpus.n_docs, bd)
        z = _per_token_to_layout(z_tok, corpus, bd)
        u = _per_token_to_layout(u_tok, corpus, bd)
        nkd = np.zeros((words.shape[0], bd, K), np.float32)
        for i in range(words.shape[0]):
            np.add.at(nkd[i], (ldoc[i], z[i]), mask[i])
        args = (words, ldoc, mask, u, z, nkd, prior, prior_k)
        jz, _, jnkv = jax_sweep(*map(jnp.asarray, args), CFG.alpha)
        tz, _, tnkv = ops.gibbs_sweep(*map(torch.from_numpy, args), CFG.alpha)
        real = mask > 0
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
        np.testing.assert_array_equal(tnkv.numpy(), np.asarray(jnkv))
        results[bd] = (np.asarray(jz)[real], np.asarray(jnkv))
    assert results[64][0].shape == (n,)
    np.testing.assert_array_equal(results[64][0], results[1][0])
    np.testing.assert_array_equal(results[64][1], results[1][1])
    assert np.any(results[64][0] != z_tok)


def _doc_index_numpy(ldoc, mask, block_docs):
    """Each document's real slots in slot order, document by document,
    then the pad slots: one slot at a time."""
    b, t = ldoc.shape
    slots, ptr = [], [0]
    for g in range(b * block_docs):
        blk, d = divmod(g, block_docs)
        slots += [blk * t + i for i in range(t)
                  if mask[blk, i] > 0 and ldoc[blk, i] == d]
        ptr.append(len(slots))
    slots += [i for i in range(b * t) if mask.reshape(-1)[i] == 0]
    return np.array(ptr, np.int32), np.array(slots, np.int32)


@pytest.mark.parametrize("layout", ["corpus", "interleaved", "gaps",
                                    "one_doc"])
def test_doc_index_matches_numpy(corpus, layout):
    """The per-document index of the blocked kernel: any order of ldoc
    within a block, documents with no tokens and pad slots."""
    rng = np.random.default_rng(len(layout))
    bd = 16
    if layout == "corpus":
        _, ldoc, mask = jgibbs.blocked_layout(
            corpus.tokens, corpus.doc_ids, corpus.n_docs, bd)
    else:
        b, t = 5, 70
        hi = {"interleaved": bd, "gaps": bd // 2, "one_doc": 1}[layout]
        ldoc = rng.integers(0, hi, (b, t)).astype(np.int32)
        if layout == "gaps":
            ldoc = 2 * ldoc + 1                     # even documents empty
        mask = (rng.uniform(size=(b, t)) > 0.2).astype(np.float32)
        mask[-1, t // 2:] = 0.0
    assert (mask == 0).any()
    want = _doc_index_numpy(ldoc, mask, bd)
    got = ops.doc_index(torch.from_numpy(ldoc), torch.from_numpy(mask), bd)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    if layout == "gaps":
        assert (np.diff(want[0])[0::2] == 0).all()


# ---------------------------------------------------------------------------
# whole fits with JAX's own draws
# ---------------------------------------------------------------------------

def _jax_draws(key, shape):
    """z0 and per-sweep uniforms as ``_cgs_sweeps`` / ``_blocked_sweeps``
    draw them (``gibbs.py:45-46,81`` and ``:154-155,166,174``)."""
    k0, key = jax.random.split(key)
    z0 = np.asarray(jax.random.randint(k0, shape, 0, K))
    u = np.stack([np.asarray(jax.random.uniform(ks, shape))
                  for ks in jax.random.split(key, SWEEPS)])
    return z0, u


@pytest.mark.parametrize("with_prior", [False, True])
def test_cgs_fit_blocked_matches_jax_with_its_draws(corpus, with_prior):
    glob = _integer_prior(5) if with_prior else None
    key = jax.random.PRNGKey(3)
    want = jgibbs.cgs_fit_blocked(corpus.tokens, corpus.doc_ids, JCFG, key,
                                  global_nkv=glob, block_docs=32,
                                  use_kernel=False)
    words, _, _ = jgibbs.blocked_layout(corpus.tokens, corpus.doc_ids,
                                        corpus.n_docs, 32)
    z0, u = _jax_draws(key, words.shape)
    got = tgibbs.cgs_fit_blocked(corpus.tokens, corpus.doc_ids, CFG, _gen(),
                                 global_nkv=glob, block_docs=32, z0=z0, u=u)
    assert got.dtype == torch.float32 and got.shape == (K, V)
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got.sum()) == corpus.n_tokens


def test_cgs_fit_matches_jax_with_its_draws(corpus):
    """The exact scan, one DSGS step against an integer global prior."""
    glob = _integer_prior(6)
    key = jax.random.PRNGKey(4)
    want = jgibbs.cgs_fit(corpus.tokens, corpus.doc_ids, JCFG, key,
                          global_nkv=glob)
    z0, u = _jax_draws(key, (corpus.n_tokens,))
    got = tgibbs.cgs_fit(corpus.tokens, corpus.doc_ids, CFG, _gen(),
                         global_nkv=glob, z0=z0, u=u)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("with_prior", [False, True])
def test_cgs_fit_keeps_one_transposed_layout(corpus, with_prior,
                                            monkeypatch):
    """``cgs_fit`` runs every sweep on n_kv and the prior in the
    kernel's (V, K) layout and still equals JAX given its draws."""
    glob = _integer_prior(8) if with_prior else None
    key = jax.random.PRNGKey(5)
    want = jgibbs.cgs_fit(corpus.tokens, corpus.doc_ids, JCFG, key,
                          global_nkv=glob)
    z0, u = _jax_draws(key, (corpus.n_tokens,))
    shapes = []
    real = tgibbs.cgs_sweep_exact_t

    def spy(*args):
        shapes.append((tuple(args[5].shape), tuple(args[7].shape)))
        return real(*args)

    monkeypatch.setattr(tgibbs, "cgs_sweep_exact_t", spy)
    got = tgibbs.cgs_fit(corpus.tokens, corpus.doc_ids, CFG, _gen(),
                         global_nkv=glob, z0=z0, u=u)
    assert shapes == [((V, K), (V, K))] * SWEEPS
    assert got.shape == (K, V) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_exact_sweep_entry_points_agree(corpus):
    """``cgs_sweep_exact_t`` ((V, K) layout) gives what ``cgs_sweep_exact``
    ((K, V), JAX's) does, on the plain version."""
    rng = np.random.default_rng(3)
    n = 800
    toks = torch.from_numpy(corpus.tokens[:n].copy())
    docs = torch.from_numpy(corpus.doc_ids[:n].copy())
    z = torch.from_numpy(rng.integers(0, K, n).astype(np.int32))
    u = torch.from_numpy(rng.uniform(size=n).astype(np.float32))
    nkd = torch.zeros((int(docs.max()) + 1, K))
    nkd.index_put_((docs.long(), z.long()), torch.ones(n), accumulate=True)
    nkv = torch.zeros((K, V))
    nkv.index_put_((z.long(), toks.long()), torch.ones(n), accumulate=True)
    glob = torch.from_numpy(_integer_prior(4))
    want = ops.cgs_sweep_exact(toks, docs, u, z, nkd, nkv, nkv.sum(1), glob,
                               glob.sum(1), CFG.alpha, CFG.eta)
    got = ops.cgs_sweep_exact_t(toks, docs, u, z, nkd, nkv.t().contiguous(),
                                nkv.sum(1), glob.t().contiguous(),
                                glob.sum(1), CFG.alpha, CFG.eta)
    assert got[2].shape == (V, K) and got[2].is_contiguous()
    for g, w in zip((got[0], got[1], got[2].t(), got[3]), want):
        assert torch.equal(g, w)
    assert not torch.equal(want[0], z)


def test_fits_refuse_draws_of_the_wrong_shape(corpus):
    with pytest.raises(ValueError, match="z0"):
        tgibbs.cgs_fit(corpus.tokens, corpus.doc_ids, CFG, _gen(),
                       z0=np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="u must be"):
        tgibbs.cgs_fit_blocked(corpus.tokens, corpus.doc_ids, CFG, _gen(),
                               u=np.zeros((SWEEPS, 2, 2), np.float32))


def test_unsorted_doc_ids_match_sorted(corpus):
    """The blocked fit stable-sorts the stream by document, so documents
    interleaved with each token order kept give the same ΔN_kv; a full
    shuffle only keeps the counts per word."""
    rng = np.random.default_rng(0)
    slot_doc = corpus.doc_ids[rng.permutation(corpus.n_tokens)]
    order = np.argsort(slot_doc, kind="stable")
    tokens = np.empty_like(corpus.tokens)
    tokens[order] = corpus.tokens
    sorted_nkv = tgibbs.cgs_fit_blocked(corpus.tokens, corpus.doc_ids, CFG,
                                        _gen(2), sweeps=3,
                                        block_docs=32)
    interleaved = tgibbs.cgs_fit_blocked(tokens, slot_doc, CFG, _gen(2),
                                         sweeps=3, block_docs=32)
    assert np.any(np.diff(slot_doc) < 0)
    torch.testing.assert_close(interleaved, sorted_nkv, rtol=0, atol=0)
    perm = rng.permutation(corpus.n_tokens)
    shuffled = tgibbs.cgs_fit_blocked(corpus.tokens[perm],
                                      corpus.doc_ids[perm], CFG, _gen(2),
                                      sweeps=3, block_docs=32)
    assert float(shuffled.sum()) == corpus.n_tokens and shuffled.min() >= 0
    np.testing.assert_array_equal(shuffled.sum(0).numpy(),
                                  sorted_nkv.sum(0).numpy())


@pytest.mark.parametrize("fit", ["cgs_fit", "cgs_fit_blocked"])
def test_empty_partition_returns_zeros(fit):
    out = getattr(tgibbs, fit)(np.empty(0, np.int32), np.empty(0, np.int32),
                               CFG, _gen())
    assert out.shape == (K, V) and not bool(out.any())


# ---------------------------------------------------------------------------
# statistical parity: blocked vs exact (the bounds of
# tests/test_gibbs_blocked.py::test_blocked_statistically_matches_exact)
# ---------------------------------------------------------------------------

def test_blocked_statistically_matches_exact(corpus):
    train, test = train_test_split(corpus, test_frac=0.15, seed=1)
    x_test = doc_term_matrix(test)
    nkv_e = tgibbs.cgs_fit(train.tokens, train.doc_ids, CFG, _gen(0))
    nkv_b = tgibbs.cgs_fit_blocked(train.tokens, train.doc_ids, CFG, _gen(0),
                                   block_docs=32)
    beta_e = topics_from_gs(nkv_e.numpy(), CFG.eta)
    beta_b = topics_from_gs(nkv_b.numpy(), CFG.eta)
    lpp_e = log_predictive_probability(beta_e, x_test)
    lpp_b = log_predictive_probability(beta_b, x_test)
    assert abs(lpp_b - lpp_e) < 0.15, (lpp_b, lpp_e)
    assert greedy_topic_overlap(beta_e, beta_b) >= 0.35


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _warp_scan(p):
    """draw_topic's running sum in csrc/gibbs_sweep.cu, one float32 add
    at a time: per-lane sums, a Hillis–Steele scan over 32 lane totals,
    each lane's exclusive offset added last."""
    f = np.float32
    k, kpl = len(p), 1
    while kpl * 32 < k:
        kpl *= 2
    cs = np.zeros((32, kpl), np.float32)
    for lane in range(32):
        run = f(0)
        for j in range(kpl):
            run = f(run + (p[lane * kpl + j] if lane * kpl + j < k else f(0)))
            cs[lane, j] = run
    incl = cs[:, -1].copy()
    for off in (1, 2, 4, 8, 16):
        incl = np.concatenate([incl[:off], incl[off:] + incl[:-off]])
    cs[1:] = cs[1:] + incl[:-1, None]
    return cs.reshape(-1)[:k]


@pytest.mark.parametrize("k", [6, 32, 33, 100, 1000])
def test_plain_version_on_the_card_sums_in_the_kernels_order(k):
    """On CUDA tensors the plain sweeps add the conditional as the warp
    scan does (``_warp_cumsum``); here that order is checked against a
    scalar replay of the kernel's adds."""
    from repro_torch.kernels.gibbs_sweep.ref import _warp_cumsum
    rng = np.random.default_rng(k)
    for _ in range(20):
        p = (rng.gamma(0.3, 1.0, k) * rng.uniform(0.01, 100)) \
            .astype(np.float32)
        np.testing.assert_array_equal(
            _warp_cumsum(torch.from_numpy(p)).numpy(), _warp_scan(p))
    batch = torch.from_numpy(rng.gamma(0.3, 1.0, (3, k)).astype(np.float32))
    rows = torch.stack([_warp_cumsum(r) for r in batch])
    assert torch.equal(_warp_cumsum(batch), rows)


def test_cpu_tensors_never_count_a_kernel_launch(corpus):
    before = (ops.gibbs_sweep_launches, ops.cgs_sweep_exact_launches)
    tgibbs.cgs_fit_blocked(corpus.tokens[:400], corpus.doc_ids[:400], CFG,
                           _gen(), sweeps=2)
    tgibbs.cgs_fit(corpus.tokens[:400], corpus.doc_ids[:400], CFG, _gen(),
                   sweeps=2)
    assert (ops.gibbs_sweep_launches, ops.cgs_sweep_exact_launches) == before


def test_wrappers_check_shapes_on_every_device(corpus):
    args = [torch.from_numpy(a) for a in _sweep_inputs(corpus, 0, False)]
    bad = list(args)
    bad[3] = bad[3][:, :-1]                       # u one slot short
    with pytest.raises(ValueError, match="u must be"):
        ops.gibbs_sweep(*bad, CFG.alpha)
    t = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="disagree"):
        ops.cgs_sweep_exact(t, t, torch.zeros(5), t, torch.zeros((2, K)),
                            torch.zeros((K, V)), torch.zeros(K + 1),
                            torch.zeros((K, V)), torch.zeros(K), 0.5, 0.05)
