"""The comparisons that decide ``correct``.

Each function takes the program's answers, works out again from the
generated corpus whatever it needs, and returns the numbers compared,
by name.  The program's own state (its store, caches, prepared
weights) is never read: a stored model's statistic is recounted from
the corpus, and the program's output is read only to be judged.

``vb_windows``: each checked window's lambda.
- ``vb_lambda_gap``: against the reference fit from the same lambda0,
  the worst topic's L1 gap over its statistic (lambda - eta), measured
  against that topic's L1 norm or the median topic's, whichever is
  larger.
- ``vb_token_error``: the statistic conserves tokens whatever the fit
  converged to: each word's phi sums to 1 over the topics, so
  sum_k (lambda_kw - eta) is the word's count in the window.  The
  largest distance from it, in tokens.

``gs_answers``: each checked answer of a gapped query.
- ``tiling_docs``: documents of sigma that the plan's reused models
  and gaps do not cover exactly once, plus any they cover outside it.
- ``count_residual``: the answer's phi decoded back to counts N, less
  the reused leaves' counts: what remains are the gaps' sampled counts,
  whole numbers up to the rounding of a float32 phi.  The largest
  distance to a whole number.
- ``token_error``: tokens the gaps' counts misplace: per word, how far
  the count over topics is from the word's count in the gaps, plus any
  negative count.
- ``sampler_gap``: how much less of the gaps' tokens the program's
  sampler puts where the corpus generated them than the reference
  sampler does on the same gaps under the same prior: with T the gaps'
  counts by generating topic, (sum(min(R, T)) - sum(min(G, T))) /
  tokens.  The prior is counted by generating topic, so both samplers
  keep the generating topics' labels; two samplers' draws differ token
  by token where topics share words, their agreement with T does not.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from bench.reference import lda

Range = Tuple[float, float]


def counts(corpus, t0: int, t1: int, device: torch.device) -> torch.Tensor:
    """(K, V) float64 counts of tokens [t0, t1) by (generating topic,
    word)."""
    k, v = corpus.n_topics, corpus.vocab_size
    z = torch.from_numpy(corpus.z[t0:t1].astype(np.int64)).to(device)
    w = torch.from_numpy(corpus.tokens[t0:t1].astype(np.int64)).to(device)
    return torch.bincount(z * v + w, minlength=k * v).reshape(k, v).to(
        torch.float64)


def _worst_topic_gap(lam: torch.Tensor, ref: torch.Tensor,
                     eta: float) -> float:
    diff = (lam.to(torch.float64) - ref).abs().sum(-1)
    norm = (ref - eta).abs().sum(-1)
    return float((diff / torch.maximum(norm, norm.median())).max())


def vb_windows(corpus, windows: Sequence[Tuple[Range, np.ndarray,
                                               torch.Tensor]],
               lda_cfg: dict, device: torch.device,
               dtype: torch.dtype = torch.float64,
               answers_from_reference: bool = False) -> Dict[str, float]:
    """``windows``: (range, the program's lambda, lambda0) per checked
    window.  With ``answers_from_reference`` the reference fit in
    ``dtype`` stands in for the program's lambda (the control).  With no
    window to check the number reads infinite."""
    names = ("vb_lambda_gap", "vb_token_error")
    if not windows:
        return dict.fromkeys(names, float("inf"))
    out = dict.fromkeys(names, 0.0)
    for (lo, hi), lam, lam0 in windows:
        t0, t1 = corpus.tokens_in(lo, hi)
        rows, cols, cnt, n_docs = lda.doc_term(
            corpus.tokens[t0:t1], corpus.doc_ids[t0:t1],
            corpus.vocab_size, device)
        fit = dict(alpha=lda_cfg["alpha"], eta=lda_cfg["eta"],
                   max_iters=lda_cfg["max_iters"],
                   e_step_iters=lda_cfg["e_step_iters"])
        ref = lda.vb_fit(rows, cols, cnt, n_docs, lam0, **fit)
        if answers_from_reference:
            lam = lda.vb_fit(rows, cols, cnt, n_docs, lam0, dtype=dtype,
                             **fit)
        else:
            lam = torch.from_numpy(np.asarray(lam)).to(device)
        if tuple(lam.shape) != tuple(ref.shape) \
                or not bool(torch.isfinite(lam).all()):
            return dict.fromkeys(names, float("inf"))
        out["vb_lambda_gap"] = max(out["vb_lambda_gap"], _worst_topic_gap(
            lam, ref, lda_cfg["eta"]))
        words = torch.zeros(corpus.vocab_size, dtype=torch.float64,
                            device=device).index_add_(0, cols,
                                                      cnt.to(torch.float64))
        held = (lam.to(torch.float64) - lda_cfg["eta"]).sum(0)
        out["vb_token_error"] = max(out["vb_token_error"],
                                    float((held - words).abs().max()))
        del ref, lam
    return out


def _doc_cover(corpus, sigma: Range, parts: Sequence[Range]) -> int:
    d0, d1 = corpus.docs_in(*sigma)
    cover = np.zeros(d1 - d0, np.int64)
    outside = 0
    for lo, hi in parts:
        p0, p1 = corpus.docs_in(lo, hi)
        i0, i1 = max(p0, d0), min(p1, d1)
        if i1 > i0:
            cover[i0 - d0:i1 - d0] += 1
        outside += (p1 - p0) - max(0, i1 - i0)
    return int((cover != 1).sum()) + outside


def _gap_tokens(corpus, gaps: Sequence[Range]):
    """(words, documents) of each gap that holds tokens."""
    out = []
    for lo, hi in gaps:
        t0, t1 = corpus.tokens_in(lo, hi)
        if t1 > t0:
            out.append((corpus.tokens[t0:t1], corpus.doc_ids[t0:t1]))
    return out


def gs_answers(corpus, answers: List[dict], lda_cfg: dict,
               prior: torch.Tensor, gen: torch.Generator,
               device: torch.device) -> Dict[str, float]:
    """``answers``: dicts with ``sigma``, ``beta`` (the program's
    answer), ``fetched`` and ``gaps`` (the plan's ranges).  ``prior``:
    the DSGS prior the store holds, recounted from the corpus.  With no
    answer to check every number reads infinite."""
    eta, v = lda_cfg["eta"], corpus.vocab_size
    names = ("tiling_docs", "count_residual", "token_error", "sampler_gap")
    if not answers:
        return {name: float("inf") for name in names}
    out = dict.fromkeys(names, 0.0)
    gap_counts, gap_sets, truths = [], [], []
    for a in answers:
        out["tiling_docs"] = max(out["tiling_docs"], float(_doc_cover(
            corpus, a["sigma"], list(a["fetched"]) + list(a["gaps"]))))
        beta = torch.as_tensor(np.asarray(a["beta"]), device=device)
        if tuple(beta.shape) != (corpus.n_topics, v) \
                or not bool(torch.isfinite(beta).all()):
            return {name: float("inf") for name in names}
        n = lda.decode_gs_topics(beta, eta)
        for lo, hi in a["fetched"]:
            n -= counts(corpus, *corpus.tokens_in(lo, hi), device)
        whole = n.round()
        out["count_residual"] = max(out["count_residual"],
                                    float((n - whole).abs().max()))
        gaps = _gap_tokens(corpus, a["gaps"])
        words = torch.zeros(v, dtype=torch.float64, device=device)
        for tok, _ in gaps:
            words += torch.bincount(torch.from_numpy(
                tok.astype(np.int64)).to(device), minlength=v)
        misplaced = ((whole.sum(0) - words).abs().sum()
                     + whole.clamp(max=0).abs().sum())
        out["token_error"] = max(out["token_error"], float(misplaced))
        gap_counts.append(whole.clamp(min=0))
        gap_sets.append(gaps)
        truths.append(sum((counts(corpus, *corpus.tokens_in(lo, hi), device)
                           for lo, hi in a["gaps"]),
                          torch.zeros_like(whole)))
    # every checked answer's gaps sampled by the reference in one pass
    flat = [gp for gaps in gap_sets for gp in gaps]
    if flat:
        ref = lda.gibbs_counts(flat, prior, alpha=lda_cfg["alpha"], eta=eta,
                               sweeps=lda_cfg["gibbs_sweeps"], gen=gen)
        i = 0
        for mine, gaps, truth in zip(gap_counts, gap_sets, truths):
            if not gaps:
                continue
            theirs = ref[i:i + len(gaps)].sum(0)
            i += len(gaps)
            n_tok = float(truth.sum())
            gap = (float(torch.minimum(theirs, truth).sum())
                   - float(torch.minimum(mine, truth).sum())) / n_tok
            out["sampler_gap"] = max(out["sampler_gap"], gap)
    return out


def control_gs_answer(corpus, sigma: Range, fetched: Sequence[Range],
                      gaps: Sequence[Range], lda_cfg: dict,
                      prior: torch.Tensor, gen: torch.Generator,
                      device: torch.device, dtype: torch.dtype
                      ) -> np.ndarray:
    """The reference put in the program's place, in ``dtype``: the
    gaps sampled, the parts summed and the answer finished."""
    total = torch.zeros((corpus.n_topics, corpus.vocab_size), dtype=dtype,
                        device=device)
    for lo, hi in fetched:
        total += counts(corpus, *corpus.tokens_in(lo, hi), device).to(dtype)
    g = _gap_tokens(corpus, gaps)
    if g:
        total += lda.gibbs_counts(
            g, prior, alpha=lda_cfg["alpha"], eta=lda_cfg["eta"],
            sweeps=lda_cfg["gibbs_sweeps"], gen=gen,
            dtype=dtype).sum(0).to(dtype)
    return lda.gs_topics(total, lda_cfg["eta"]).float().cpu().numpy()
