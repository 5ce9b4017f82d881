"""Plain reference of a covered VB answer, and the comparisons that
decide ``correct`` for the explore cells.

A covered answer merges the stored leaves that tile sigma (Alg. 1):
lambda* = eta + sum over leaves of (lambda_leaf - eta), and the
capital's lambda_leaf is eta + the leaf's counts by (generating topic,
word).  So lambda* = eta + the counts of sigma's tokens, and
beta = lambda* over its row sums.  The reference recounts those counts
from the generated corpus in float64, whatever the program fetched; it
reads nothing of the program's store or device tensors.

``vb_answers``: each checked answer.
- ``tiling_docs``: documents of sigma that the fetched leaves do not
  cover exactly once, plus any they cover outside it.
- ``vb_beta_gap``: the worst topic's L1 distance between the program's
  beta row and the reference's (rows sum to 1, so it lies in [0, 2]).

``control_answer`` is the reference put in the program's place in a
given dtype: each fetched leaf's lambda rounded to the dtype, the merge
summed and normalised in it.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from bench.reference.checks import _doc_cover, counts

Range = Tuple[float, float]
NAMES = ("tiling_docs", "vb_beta_gap")


def reference_beta(corpus, sigma: Range, eta: float,
                   device: torch.device) -> torch.Tensor:
    """(K, V) float64: eta + sigma's counts, over their row sums."""
    lam = counts(corpus, *corpus.tokens_in(*sigma), device) + eta
    return lam / lam.sum(-1, keepdim=True)


def vb_answers(corpus, answers: List[dict], eta: float,
               device: torch.device) -> Dict[str, float]:
    """``answers``: dicts with ``sigma``, ``beta`` (the program's answer)
    and ``fetched`` (the plan's leaves).  With no answer to check, or an
    answer of the wrong shape or not finite, every number reads
    infinite."""
    if not answers:
        return dict.fromkeys(NAMES, float("inf"))
    out = dict.fromkeys(NAMES, 0.0)
    shape = (corpus.n_topics, corpus.vocab_size)
    for a in answers:
        out["tiling_docs"] = max(out["tiling_docs"], float(_doc_cover(
            corpus, a["sigma"], list(a["fetched"]))))
        beta = torch.as_tensor(np.asarray(a["beta"]), device=device)
        if tuple(beta.shape) != shape or not bool(torch.isfinite(beta).all()):
            return dict.fromkeys(NAMES, float("inf"))
        gap = (beta.to(torch.float64) - reference_beta(
            corpus, a["sigma"], eta, device)).abs().sum(-1).max()
        out["vb_beta_gap"] = max(out["vb_beta_gap"], float(gap))
    return out


def control_answer(corpus, fetched: Sequence[Range], eta: float,
                   device: torch.device, dtype: torch.dtype) -> np.ndarray:
    """The merge of the fetched leaves computed in ``dtype``: each
    leaf's lambda = eta + its counts rounded to ``dtype``, then
    eta + sum (lambda - eta) and its row normalisation in ``dtype``."""
    total = torch.full((corpus.n_topics, corpus.vocab_size), eta,
                       dtype=dtype, device=device)
    for lo, hi in fetched:
        lam = (counts(corpus, *corpus.tokens_in(lo, hi), device)
               + eta).to(dtype)
        total += lam - eta
    beta = total / total.sum(-1, keepdim=True)
    return beta.float().cpu().numpy()
