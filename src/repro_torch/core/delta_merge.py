"""Delta merging for LM parameters — the paper's Eq. 6 analogue for
non-exponential-family models.

LDA models merge exactly because their posteriors are exponential-family
(Alg. 1: λ* = η + Σ w_i (λ_i − η)).  LM fine-tunes have no such
guarantee, but the same *shape* of update — accumulate weighted deltas
from a common prior — is the task-vector merge: given a base parameter
tree θ0 and fine-tuned trees θ_i trained on n_i tokens,

    θ* = θ0 + Σ_i w_i (θ_i − θ0),      w_i = n_i / Σ n_j  (or custom)

This lets the MLego store/planner manage LM range-models with the SAME
⟨o, N, Θ⟩ tuple and the SAME plan search: only the merge operator
differs (approximate here, exact for LDA).

A tree is nested dicts, lists and tuples whose leaves are tensors,
numpy arrays or numbers (the JAX package maps over a pytree).  Each leaf
is combined in float32 and cast back to its own dtype; a tensor leaf
stays a tensor on its device, any other leaf becomes a numpy array.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _tree_map(fn, base, *others):
    if isinstance(base, dict):
        return {k: _tree_map(fn, v, *(o[k] for o in others))
                for k, v in base.items()}
    if isinstance(base, (list, tuple)):
        return type(base)(_tree_map(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(base))
    return fn(base, *others)


def _combine(w: Sequence[float], b, *ts):
    if isinstance(b, torch.Tensor):
        b32 = b.to(torch.float32)
        delta = sum(wi * (t.to(b.device, torch.float32) - b32)
                    for wi, t in zip(w, ts))
        return (b32 + delta).to(b.dtype)
    b32 = np.asarray(b, np.float32)
    delta = sum(wi * (np.asarray(t, np.float32) - b32)
                for wi, t in zip(w, ts))
    return (b32 + delta).astype(np.asarray(b).dtype)


def merge_param_deltas(base, tuned: Sequence,
                       weights: Optional[Sequence[float]] = None):
    """θ* = θ0 + Σ w_i (θ_i − θ0) over parameter trees.

    ``weights`` defaults to uniform 1/n (the SDA-Bayes form uses data
    counts — pass n_i / Σ n_j).  Order-independent and associative in
    Θ-space, like Alg. 1.
    """
    if not tuned:
        raise ValueError("nothing to merge")
    n = len(tuned)
    w = [1.0 / n] * n if weights is None else list(weights)
    if len(w) != n:
        raise ValueError("weights/models length mismatch")
    return _tree_map(lambda b, *ts: _combine(w, b, *ts), base, *tuned)
