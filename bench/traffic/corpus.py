"""Corpus and reuse capital made from a seed, in a few large calls.

The corpus follows the LDA generative model the port's
``data/corpus.py::make_corpus`` samples (topic-word rows from a
Dirichlet(eta), document-topic rows from a Dirichlet(alpha), Poisson
document lengths of at least 4 tokens, ``attr`` sorted uniform over
[0, attr_max)), written with whole-tensor operations on the device so
that a corpus of 100M tokens takes seconds and not minutes:

- every document's topics at once, by inverse-CDF search in its row;
- the words topic by topic, by inverse-CDF search in the topic's row.

Within a document the tokens come in an order of their own; LDA is a
bag of words, so that order carries nothing.  The generating topic of
every token is kept (``z``): the capital is built from it.

The capital stands in for well-converged fits.  Each stored model
covers one leaf of ``leaf_units`` attribute units and holds the counts
of its own tokens by (generating topic, word): ``eta + counts`` as a
"vb" model's lambda, the counts as a "gs" model's delta N_kv.

Nothing here imports the program: the arrays are handed to it and to
the reference alike.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np
import torch


@dataclass
class GenCorpus:
    """A generated corpus, on the host.

    tokens  int32 (T,)    word of every token, documents in order
    doc_ids int32 (T,)    document of every token
    offsets int64 (D+1,)  token offsets of the documents
    attr    float64 (D,)  sorted attribute of every document
    z       int16 (T,)    generating topic of every token
    """

    tokens: np.ndarray
    doc_ids: np.ndarray
    offsets: np.ndarray
    attr: np.ndarray
    z: np.ndarray
    vocab_size: int
    n_topics: int

    @property
    def n_docs(self) -> int:
        return len(self.offsets) - 1

    @property
    def n_tokens(self) -> int:
        return int(self.offsets[-1])

    def docs_in(self, lo: float, hi: float) -> Tuple[int, int]:
        """[d0, d1): the documents whose attr lies in [lo, hi)."""
        d0, d1 = np.searchsorted(self.attr, [lo, hi], side="left")
        return int(d0), int(d1)

    def tokens_in(self, lo: float, hi: float) -> Tuple[int, int]:
        """[t0, t1): the tokens of the documents in [lo, hi)."""
        d0, d1 = self.docs_in(lo, hi)
        return int(self.offsets[d0]), int(self.offsets[d1])


def _dirichlet(conc: float, shape, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """Rows from a symmetric Dirichlet, in float64 (small concentrations
    underflow float32 gammas to whole rows of zeros)."""
    g = torch._standard_gamma(
        torch.full(shape, conc, dtype=torch.float64, device=device),
        generator=gen)
    return g / g.sum(-1, keepdim=True)


def _search(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw: index of the first cdf entry above u * total."""
    idx = torch.searchsorted(cdf, u * cdf[..., -1:], right=True)
    return idx.clamp_(max=cdf.shape[-1] - 1)


def make_corpus(n_docs: int, vocab_size: int, n_topics: int, *,
                mean_doc_len: float, alpha: float, eta: float,
                attr_max: float, seed: int,
                device: torch.device) -> GenCorpus:
    """Sample a corpus from the LDA generative model, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    beta = _dirichlet(eta, (n_topics, vocab_size), gen, device)
    theta = _dirichlet(alpha, (n_docs, n_topics), gen, device)
    lengths = torch.poisson(
        torch.full((n_docs,), float(mean_doc_len), dtype=torch.float64,
                   device=device), generator=gen).clamp_(min=4).long()
    offsets = torch.zeros(n_docs + 1, dtype=torch.long, device=device)
    torch.cumsum(lengths, 0, out=offsets[1:])
    total = int(offsets[-1])
    doc_ids = torch.repeat_interleave(
        torch.arange(n_docs, dtype=torch.int32, device=device), lengths)
    # topics: each token searches its own document's cumulative row, in
    # chunks of documents so the (docs, longest) grid stays small
    z = torch.empty(total, dtype=torch.int16, device=device)
    cdf_theta = theta.cumsum(-1)
    max_len = int(lengths.max())
    chunk = max(1, (1 << 25) // max_len)
    for d0 in range(0, n_docs, chunk):
        d1 = min(n_docs, d0 + chunk)
        u = torch.rand((d1 - d0, max_len), dtype=torch.float64,
                       generator=gen, device=device)
        zz = _search(cdf_theta[d0:d1].contiguous(), u)
        keep = (torch.arange(max_len, device=device)[None, :]
                < lengths[d0:d1, None])
        z[int(offsets[d0]):int(offsets[d1])] = zz[keep].to(torch.int16)
    # words: topic by topic over the tokens that topic generated
    tokens = torch.empty(total, dtype=torch.int32, device=device)
    order = torch.argsort(z, stable=True)
    per_topic = torch.bincount(z.long(), minlength=n_topics).tolist()
    cdf_beta = beta.cumsum(-1)
    start = 0
    for k, n in enumerate(per_topic):
        if n:
            u = torch.rand(n, dtype=torch.float64, generator=gen,
                           device=device)
            tokens[order[start:start + n]] = _search(
                cdf_beta[k], u).to(torch.int32)
        start += n
    attr = torch.sort(torch.rand(n_docs, dtype=torch.float64,
                                 generator=gen, device=device)
                      * attr_max).values
    return GenCorpus(tokens=tokens.cpu().numpy(),
                     doc_ids=doc_ids.cpu().numpy(),
                     offsets=offsets.cpu().numpy(),
                     attr=attr.cpu().numpy(), z=z.cpu().numpy(),
                     vocab_size=vocab_size, n_topics=n_topics)


def leaves(attr_max: float, leaf_units: float) -> Iterator[Tuple[float, float]]:
    """The capital's leaves: [i * leaf, (i + 1) * leaf) up to attr_max."""
    n = int(np.ceil(attr_max / leaf_units))
    for i in range(n):
        yield i * leaf_units, (i + 1) * leaf_units


def topic_word_counts(corpus: GenCorpus, t0: int, t1: int,
                      device: torch.device) -> torch.Tensor:
    """(K, V) float32 counts of tokens [t0, t1) by (generating topic,
    word), on ``device``."""
    k, v = corpus.n_topics, corpus.vocab_size
    z = torch.from_numpy(corpus.z[t0:t1]).to(device).long()
    w = torch.from_numpy(corpus.tokens[t0:t1]).to(device).long()
    return torch.bincount(z * v + w, minlength=k * v).reshape(
        k, v).to(torch.float32)


def capital_stat(corpus: GenCorpus, lo: float, hi: float, kind: str,
                 eta: float, device: torch.device) -> np.ndarray:
    """A stored model's statistic on [lo, hi): ``eta + counts`` for
    "vb", the counts for "gs"."""
    counts = topic_word_counts(corpus, *corpus.tokens_in(lo, hi), device)
    if kind == "vb":
        counts += eta
    elif kind != "gs":
        raise ValueError(f"no capital form for kind {kind!r}")
    return counts.cpu().numpy()
