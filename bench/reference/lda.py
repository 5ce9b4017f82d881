"""Plain reference of the LDA arithmetic the benchmark checks.

Written from the model's equations with torch tensor operations alone;
it imports nothing of the program.  Every function takes a ``dtype``,
so that the same code, run in a lower precision than the configuration
states, is the control that the comparison must refuse.

- :func:`vb_fit` is batch variational Bayes (Hoffman et al.): 20
  coordinate-ascent E-step iterations from gamma = 1 per outer
  iteration, lambda = eta + sufficient statistics, on a sparse
  doc-term matrix.
- :func:`gibbs_counts` is collapsed Gibbs sampling with the DSGS prior
  (a fixed global N_kv, paper Eq. 8): every document's chain resamples
  its tokens in order with its document-topic counts exact, against a
  per-sweep snapshot of its gap's topic-word counts plus the prior.
- :func:`gs_topics` / :func:`decode_gs_topics` are Alg. 2's finish
  phi = (N + eta) / (N_k + V eta) and its inverse.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def doc_term(tokens: np.ndarray, doc_ids: np.ndarray, vocab: int,
             device: torch.device
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """(rows, cols, counts, n_docs) of the doc-term matrix of a stretch
    of documents, documents numbered from the stretch's first."""
    d = torch.from_numpy(doc_ids.astype(np.int64)).to(device)
    d = d - d.min()
    w = torch.from_numpy(tokens.astype(np.int64)).to(device)
    keys, cnt = torch.unique(d * vocab + w, return_counts=True)
    n_docs = int(d.max()) + 1
    return keys // vocab, keys % vocab, cnt, n_docs


def _exp_elog(x: torch.Tensor) -> torch.Tensor:
    """exp(E[log p]) of Dirichlet rows: exp(digamma(x) - digamma(sum))."""
    return torch.exp(torch.special.digamma(x)
                     - torch.special.digamma(x.sum(-1, keepdim=True)))


def vb_fit(rows: torch.Tensor, cols: torch.Tensor, cnt: torch.Tensor,
           n_docs: int, lam0: torch.Tensor, *, alpha: float, eta: float,
           max_iters: int, e_step_iters: int,
           dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Batch VB from lambda0 (K, V).  Returns lambda (K, V) in ``dtype``."""
    lam = lam0.to(dtype)
    k, v = lam.shape
    x = cnt.to(dtype)
    for _ in range(max_iters):
        eeb = _exp_elog(lam)                       # (K, V)
        b = eeb.t()[cols]                          # (nnz, K) at the nonzeros
        gamma = torch.ones((n_docs, k), dtype=dtype, device=lam.device)
        for _ in range(e_step_iters):
            et = _exp_elog(gamma)
            ratio = x / ((et[rows] * b).sum(-1) + 1e-30)
            dot = torch.zeros_like(gamma).index_add_(0, rows,
                                                     ratio[:, None] * b)
            gamma = alpha + et * dot
        et = _exp_elog(gamma)
        ratio = x / ((et[rows] * b).sum(-1) + 1e-30)
        sstats = torch.zeros((v, k), dtype=dtype, device=lam.device)
        sstats.index_add_(0, cols, ratio[:, None] * et[rows])
        lam = eta + sstats.t() * eeb
    return lam


def gibbs_counts(gaps: Sequence[Tuple[np.ndarray, np.ndarray]],
                 prior: torch.Tensor, *, alpha: float, eta: float,
                 sweeps: int, gen: torch.Generator,
                 dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Collapsed Gibbs over each gap (its tokens' words and documents)
    under the fixed prior N_kv (K, V).  Returns each gap's topic-word
    counts of its final assignments, (G, K, V) float64."""
    dev = prior.device
    k, v = prior.shape
    n_gaps = len(gaps)
    # one chain per document: (n_docs, L) words, padded past each length
    lens: List[np.ndarray] = []
    words: List[np.ndarray] = []
    owner: List[np.ndarray] = []
    for g, (tok, doc) in enumerate(gaps):
        _, start, count = np.unique(doc, return_index=True,
                                    return_counts=True)
        lens.append(count)
        words.extend(tok[s:s + c] for s, c in zip(start, count))
        owner.append(np.full(len(count), g))
    out = torch.zeros((n_gaps, k, v), dtype=torch.float64, device=dev)
    if not words:
        return out
    lens_np = np.concatenate(lens)
    n_docs, width = len(lens_np), int(lens_np.max())
    grid = np.zeros((n_docs, width), np.int64)
    for i, w in enumerate(words):
        grid[i, :len(w)] = w
    wd = torch.from_numpy(grid).to(dev)
    gd = torch.from_numpy(np.concatenate(owner)).to(dev)
    ln = torch.from_numpy(lens_np).to(dev)
    live = torch.arange(width, device=dev)[None, :] < ln[:, None]
    z = torch.randint(0, k, (n_docs, width), generator=gen, device=dev)
    rows = torch.arange(n_docs, device=dev)
    nkd = torch.zeros((n_docs, k), dtype=dtype, device=dev)
    nkd.index_put_((rows[:, None].expand_as(z)[live], z[live]),
                   torch.ones((), dtype=dtype, device=dev), accumulate=True)
    kk = torch.arange(k, device=dev)

    def topic_word(z: torch.Tensor) -> torch.Tensor:
        flat = (gd[:, None] * k + z) * v + wd
        c = torch.bincount(flat[live], minlength=n_gaps * k * v)
        return c.reshape(n_gaps, k, v).to(torch.float64)

    glob = prior.to(dtype)
    for _ in range(sweeps):
        snap = (topic_word(z).to(dtype) + glob[None] + eta)  # (G, K, V)
        snap_k = snap.sum(-1)                                  # (G, K)
        u = torch.rand((n_docs, width), generator=gen, device=dev,
                       dtype=torch.float64)
        for j in range(width):
            on = live[:, j]
            old = z[:, j]
            own = ((kk[None, :] == old[:, None]) & on[:, None]).to(dtype)
            num = snap[gd, :, wd[:, j]] - own
            p = (nkd - own + alpha) * num / (snap_k[gd] - own)
            c = p.to(torch.float64).cumsum(-1)
            new = torch.searchsorted(c, (u[:, j] * c[:, -1])[:, None],
                                     right=True)[:, 0].clamp_(max=k - 1)
            new = torch.where(on, new, old)
            nkd = nkd - own
            nkd[rows, new] += on.to(dtype)
            z[:, j] = new
    return topic_word(z)


def gs_topics(nkv: torch.Tensor, eta: float) -> torch.Tensor:
    """Alg. 2's finish: phi_kv = (N_kv + eta) / (N_k + V eta)."""
    v = nkv.shape[1]
    return (nkv + eta) / (nkv.sum(-1, keepdim=True) + v * eta)


def decode_gs_topics(beta: torch.Tensor, eta: float) -> torch.Tensor:
    """The counts N (K, V) behind a finished Alg. 2 answer, in float64.

    A word no token of topic k took has phi_kv = eta / (N_k + V eta),
    the row's least entry; so N_k + V eta = eta / min_v phi_kv and
    N_kv = phi_kv (N_k + V eta) - eta."""
    b = beta.to(torch.float64)
    scale = eta / b.min(-1, keepdim=True).values
    return b * scale - eta


def session_lambda0(seed: int, call: int, k: int, v: int,
                    device: torch.device) -> torch.Tensor:
    """lambda0 of a session's ``call``-th training call (from 0), worked
    out again from the session's seed by the port's stated rule: the
    session's CPU stream (``torch.Generator().manual_seed(seed)``) draws
    one seed below 2**62 per training call, which seeds a generator on
    the device, from which lambda0 = Gamma(100) * 0.01 is drawn in
    float32 (``MLegoSession``'s and ``core/vb.py``'s docstrings)."""
    stream = torch.Generator().manual_seed(seed)
    for _ in range(call + 1):
        s = int(torch.randint(0, 2 ** 62, (), generator=stream))
    gen = torch.Generator(device=device).manual_seed(s)
    return torch._standard_gamma(
        torch.full((k, v), 100.0, dtype=torch.float32, device=device),
        generator=gen) * 0.01
