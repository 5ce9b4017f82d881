"""Frozen work counts of MLego's model operations, and one H100's peaks.

Each function gives the bytes and operations one call needs, from the
shapes of its inputs alone: each input read once, each output written
once.  They are copies of the arithmetic in the port's
``kernels/{merge_topics,vb_estep,gibbs_sweep}/ops.py::cost`` as it
stood when the benchmark was written, kept here so that a later change
to the program cannot change the yardstick.  The one departure is the
Gibbs sweep: the port counts the per-token arrays over its blocked
layout's padded width (``t_max`` slots in every block), which is the
implementation's padding; :func:`gibbs_sweep` counts the gap's real
tokens and documents, so the count does not depend on the block size.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

# one H100 SXM's published peaks (NVIDIA data sheet, 700 W):
# HBM bytes/s and float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


@dataclass(frozen=True)
class Work:
    """What one call must do: bytes moved and float32 operations."""

    n_bytes: float
    n_ops: float

    def least_s(self) -> float:
        """The least time one H100 could take: the larger of the bytes
        at the HBM rate and the operations at the float32 peak."""
        return max(self.n_bytes / PEAK_BYTES_S, self.n_ops / PEAK_F32_FLOPS)

    def __add__(self, other: "Work") -> "Work":
        return Work(self.n_bytes + other.n_bytes, self.n_ops + other.n_ops)


def merge(n: int, k: int, v: int) -> Work:
    """One merge of ``n`` (K, V) float32 statistics with unit weights:
    the statistics and weights read once, the (K, V) result written
    once; 3 operations per input element (product, sum, bias)."""
    return Work(4.0 * (n * k * v + n + k * v), 3.0 * n * k * v)


def merge_segments(counts: Sequence[int], k: int, v: int) -> Work:
    """One ragged merge of segments of ``counts`` statistics: the
    statistics, weights and offsets read once, one (K, V) result per
    segment written once."""
    r, n = int(sum(counts)), len(counts)
    return Work(4.0 * (r * k * v + r + n + 1 + n * k * v), 3.0 * r * k * v)


def vb_estep(d: int, k: int, v: int, nnz: int, n_iters: int) -> Work:
    """One E-step call on a (D, V) doc-term matrix of ``nnz`` nonzeros:
    the sparse matrix and its index arrays, exp E[log beta] and gamma0
    read once, gamma and the sufficient statistics written once; per
    iteration 4 K + 1 operations at each nonzero and ~62 per gamma entry
    (digamma and exp), then the final product with exp E[log beta]."""
    n_bytes = 4.0 * (4 * nnz + d + 1 + v + 1 + k * v + 2 * d * k + k * v)
    n_ops = (n_iters + 1) * (4.0 * k * nnz + nnz + 62.0 * d * k) + k * v
    return Work(n_bytes, n_ops)


def gibbs_sweep(n_tokens: int, n_docs: int, k: int, v: int) -> Work:
    """One collapsed-Gibbs sweep over ``n_tokens`` tokens of ``n_docs``
    documents against a frozen (K, V) snapshot: per token its word, its
    document, its uniform and its topic in and out; the documents'
    topic counts in and out; the snapshot and its row sums in and the
    new topic-word counts out; ~8 operations per topic per token."""
    n_bytes = 4.0 * (5 * n_tokens + 2 * n_docs * k + 2 * k * v + k)
    return Work(n_bytes, 8.0 * k * n_tokens)


def gibbs_work_of(doc_ids: np.ndarray, k: int, v: int) -> Work:
    """One sweep's work over a gap given its tokens' document ids."""
    n_docs = int(np.unique(doc_ids).size) if len(doc_ids) else 0
    return gibbs_sweep(len(doc_ids), n_docs, k, v)
