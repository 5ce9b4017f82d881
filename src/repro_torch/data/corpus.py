"""Corpus synthesis + range indexing for MLego analytic queries.

Documents are sampled from the LDA generative model itself, so held-out
log-predictive-probability (lpp) is a meaningful accuracy signal for the
merge-vs-scratch comparisons.  Each document carries an ordered
dimension attribute (``attr`` — think id / timestamp / geohash bucket)
that the analytic-query predicates range over, mirroring the paper's
Random (id-range) and OLAP (hierarchy-range) workloads.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Corpus:
    """A bag-of-words corpus with an ordered OLAP attribute per doc.

    tokens     : int32 (total_tokens,)  word id of every token
    doc_ids    : int32 (total_tokens,)  owning document of every token
    doc_offsets: int64 (n_docs + 1,)    CSR offsets into ``tokens``
    attr       : float64 (n_docs,)      sorted ascending dimension attribute
    vocab_size : V
    """

    tokens: np.ndarray
    doc_ids: np.ndarray
    doc_offsets: np.ndarray
    attr: np.ndarray
    vocab_size: int

    @property
    def n_docs(self) -> int:
        return len(self.doc_offsets) - 1

    @property
    def n_tokens(self) -> int:
        return int(self.doc_offsets[-1])

    def doc_lengths(self) -> np.ndarray:
        return np.diff(self.doc_offsets)

    # --- range selection ---------------------------------------------------
    def doc_slice(self, lo: float, hi: float) -> Tuple[int, int]:
        """[d0, d1) of documents whose attr lies in [lo, hi)."""
        d0 = bisect.bisect_left(self.attr.tolist(), lo)
        d1 = bisect.bisect_left(self.attr.tolist(), hi)
        return d0, d1

    def subset(self, lo: float, hi: float) -> "Corpus":
        d0, d1 = self.doc_slice(lo, hi)
        t0, t1 = int(self.doc_offsets[d0]), int(self.doc_offsets[d1])
        return Corpus(
            tokens=self.tokens[t0:t1],
            doc_ids=self.doc_ids[t0:t1] - d0,
            doc_offsets=self.doc_offsets[d0 : d1 + 1] - self.doc_offsets[d0],
            attr=self.attr[d0:d1],
            vocab_size=self.vocab_size,
        )


class DataIndex:
    """O(log n) doc/token counting over attribute ranges (prefix sums)."""

    def __init__(self, corpus: Corpus):
        self._attr = corpus.attr
        self._tok_prefix = corpus.doc_offsets  # already a token prefix sum

    def count(self, lo: float, hi: float) -> Tuple[int, int]:
        """(#docs, #tokens) with attr in [lo, hi)."""
        d0 = np.searchsorted(self._attr, lo, side="left")
        d1 = np.searchsorted(self._attr, hi, side="left")
        return int(d1 - d0), int(self._tok_prefix[d1] - self._tok_prefix[d0])

    def tokens_in(self, lo: float, hi: float) -> int:
        return self.count(lo, hi)[1]

    def docs_in(self, lo: float, hi: float) -> int:
        return self.count(lo, hi)[0]


def make_corpus(
    n_docs: int,
    vocab_size: int,
    n_topics: int,
    *,
    mean_doc_len: int = 64,
    alpha: float = 0.1,
    eta: float = 0.05,
    attr_max: Optional[float] = None,
    seed: int = 0,
) -> Tuple[Corpus, np.ndarray]:
    """Sample a corpus from the LDA generative model.

    Returns (corpus, true_beta) where true_beta is (K, V) row-stochastic.
    """
    rng = np.random.default_rng(seed)
    beta = rng.dirichlet(np.full(vocab_size, eta), size=n_topics)  # (K, V)
    lengths = np.maximum(rng.poisson(mean_doc_len, size=n_docs), 4)
    offsets = np.zeros(n_docs + 1, np.int64)
    offsets[1:] = np.cumsum(lengths)
    total = int(offsets[-1])
    tokens = np.empty(total, np.int32)
    doc_ids = np.empty(total, np.int32)
    theta = rng.dirichlet(np.full(n_topics, alpha), size=n_docs)  # (D, K)
    for d in range(n_docs):
        z = rng.choice(n_topics, size=lengths[d], p=theta[d])
        # sample words per topic in bulk
        for k in np.unique(z):
            sel = z == k
            tokens[offsets[d] : offsets[d + 1]][sel] = rng.choice(
                vocab_size, size=int(sel.sum()), p=beta[k]
            )
        doc_ids[offsets[d] : offsets[d + 1]] = d
    attr_max = attr_max if attr_max is not None else float(n_docs)
    attr = np.sort(rng.uniform(0.0, attr_max, size=n_docs))
    corpus = Corpus(
        tokens=tokens,
        doc_ids=doc_ids,
        doc_offsets=offsets,
        attr=attr,
        vocab_size=vocab_size,
    )
    return corpus, beta


def concat_corpora(a: Corpus, b: Corpus) -> Corpus:
    """Append corpus ``b``'s documents after ``a``'s (streaming growth).

    The result is a valid ``Corpus`` only if the combined ``attr``
    stays sorted, i.e. ``b`` is *newer* than ``a`` (append-only
    ingestion) — enforced here because every range structure
    (``doc_slice``, ``DataIndex``) depends on attr order.
    """
    if a.vocab_size != b.vocab_size:
        raise ValueError(f"vocab mismatch: {a.vocab_size} vs {b.vocab_size}")
    if b.n_docs == 0:
        return a
    if a.n_docs == 0:
        return b
    if float(b.attr[0]) < float(a.attr[-1]):
        raise ValueError(
            f"append-only: incoming batch starts at attr {b.attr[0]} "
            f"below the existing frontier {a.attr[-1]}")
    offsets = np.zeros(a.n_docs + b.n_docs + 1, np.int64)
    offsets[: a.n_docs + 1] = a.doc_offsets
    offsets[a.n_docs + 1 :] = b.doc_offsets[1:] + a.n_tokens
    return Corpus(
        tokens=np.concatenate([a.tokens, b.tokens]),
        doc_ids=np.concatenate([a.doc_ids,
                                b.doc_ids + np.int32(a.n_docs)]),
        doc_offsets=offsets,
        attr=np.concatenate([a.attr, b.attr]),
        vocab_size=a.vocab_size,
    )


def doc_term_matrix(corpus: Corpus, d0: int = 0, d1: Optional[int] = None) -> np.ndarray:
    """Dense (D, V) float32 doc-term count matrix for docs [d0, d1)."""
    d1 = corpus.n_docs if d1 is None else d1
    n = d1 - d0
    x = np.zeros((n, corpus.vocab_size), np.float32)
    t0, t1 = int(corpus.doc_offsets[d0]), int(corpus.doc_offsets[d1])
    np.add.at(x, (corpus.doc_ids[t0:t1] - d0, corpus.tokens[t0:t1]), 1.0)
    return x


def train_test_split(corpus: Corpus, test_frac: float = 0.1, seed: int = 0):
    """Split *documents* into train/test corpora (attr order preserved)."""
    rng = np.random.default_rng(seed)
    n = corpus.n_docs
    test_mask = rng.uniform(size=n) < test_frac
    return _take(corpus, ~test_mask), _take(corpus, test_mask)


def _take(corpus: Corpus, mask: np.ndarray) -> Corpus:
    doc_idx = np.nonzero(mask)[0]
    lengths = corpus.doc_lengths()[doc_idx]
    offsets = np.zeros(len(doc_idx) + 1, np.int64)
    offsets[1:] = np.cumsum(lengths)
    tokens = np.concatenate(
        [
            corpus.tokens[corpus.doc_offsets[d] : corpus.doc_offsets[d + 1]]
            for d in doc_idx
        ]
    ) if len(doc_idx) else np.empty(0, np.int32)
    doc_ids = np.repeat(np.arange(len(doc_idx), dtype=np.int32), lengths)
    return Corpus(
        tokens=tokens.astype(np.int32),
        doc_ids=doc_ids,
        doc_offsets=offsets,
        attr=corpus.attr[doc_idx],
        vocab_size=corpus.vocab_size,
    )
