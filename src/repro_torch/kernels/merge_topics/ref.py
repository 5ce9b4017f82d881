"""Plain PyTorch versions of the weighted topic-statistic merge (Alg. 1/2).

    out = bias + sum_i w_i * (stats_i - base)

covers both merges:
  MVB (Alg. 1): bias = eta,  base = eta   (λ* = η + Σ w_i (λ_i − η))
  MGS (Alg. 2): bias = 0,    base = 0,  w_i = decay^{s_i}

The wrappers in ``ops.py`` run these only for CPU tensors; on the card
they are what the kernels are held against.
"""
from __future__ import annotations

from typing import Sequence

import torch


def merge_topics_ref(stats: torch.Tensor, weights: torch.Tensor,
                     bias: float = 0.0, base: float = 0.0) -> torch.Tensor:
    """stats: (n, K, V); weights: (n,).  Returns (K, V) float32."""
    w = weights.to(torch.float32)[:, None, None]
    return bias + (w * (stats.to(torch.float32) - base)).sum(0)


def merge_topics_batched_ref(stats: torch.Tensor, weights: torch.Tensor,
                             bias: float = 0.0, base: float = 0.0
                             ) -> torch.Tensor:
    """b independent merges: stats (b, n, K, V), weights (b, n) ->
    (b, K, V) float32."""
    w = weights.to(torch.float32)[:, :, None, None]
    return bias + (w * (stats.to(torch.float32) - base)).sum(1)


def merge_topics_segments_ref(stats: torch.Tensor, weights: torch.Tensor,
                              counts: Sequence[int], bias: float = 0.0,
                              base: float = 0.0) -> torch.Tensor:
    """Segmented merge: stats (R, K, V) rows grouped by ``counts``
    (sum(counts) == R) -> (len(counts), K, V)."""
    out, r = [], 0
    for n in counts:
        out.append(merge_topics_ref(stats[r:r + n], weights[r:r + n],
                                    bias, base))
        r += n
    return torch.stack(out)
