"""LDA state and the materialized-model tuple ⟨o, N, Θ⟩ (paper §III.B).

A materialized model is exactly the paper's tuple:
  o : the dimension-attribute range the model was trained on (Interval)
  N : data volume — we track both #docs and #tokens (the cost model is
      token-based, the merge weights are doc-based)
  Θ : mergeable parameters, depending on the inference algorithm:
        kind == "vb": {"lam": λ (K, V) Dirichlet variational params}
        kind == "gs": {"delta_nkv": ΔN_kv (K, V) topic-word count delta}
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.lda_default import LDAConfig
from repro_torch.core.plans import Interval


@dataclass(frozen=True)
class MaterializedModel:
    model_id: int
    o: Interval                 # predicate range the model covers
    n_docs: int
    n_tokens: int
    kind: str                   # "vb" | "gs"
    theta: Dict[str, np.ndarray]

    @property
    def lam(self) -> np.ndarray:
        return self.theta["lam"]

    @property
    def delta_nkv(self) -> np.ndarray:
        return self.theta["delta_nkv"]

    def nbytes(self) -> int:
        return sum(int(v.nbytes) for v in self.theta.values())


def topics_from_vb(lam: np.ndarray) -> np.ndarray:
    """Posterior-mean topic-word distributions from Dirichlet params."""
    return lam / lam.sum(axis=1, keepdims=True)


def topics_from_gs(nkv: np.ndarray, eta: float) -> np.ndarray:
    """φ_kv = (N_kv + η) / (N_k + V η)  (paper Alg. 2 line 8)."""
    v = nkv.shape[1]
    return (nkv + eta) / (nkv.sum(axis=1, keepdims=True) + v * eta)


def model_topics(model: MaterializedModel, cfg: LDAConfig) -> np.ndarray:
    if model.kind == "vb":
        return topics_from_vb(model.lam)
    return topics_from_gs(model.delta_nkv, cfg.eta)


def greedy_topic_overlap(beta_a: np.ndarray, beta_b: np.ndarray,
                         top_n: int = 20) -> float:
    """Fraction of shared top-``top_n`` words under greedy 1:1 topic
    matching — the sampler-agnostic quality-parity metric the blocked
    Gibbs bench and its regression tests share (samplers permute
    topics, so rows must be matched before comparing)."""
    k = beta_a.shape[0]
    tops_a = [set(np.argsort(beta_a[i])[-top_n:].tolist()) for i in range(k)]
    tops_b = [set(np.argsort(beta_b[i])[-top_n:].tolist()) for i in range(k)]
    m = np.array([[len(a & b) for b in tops_b] for a in tops_a])
    total = 0
    for _ in range(k):
        i, j = np.unravel_index(np.argmax(m), m.shape)
        total += m[i, j]
        m[i, :] = -1
        m[:, j] = -1
    return total / (k * top_n)


def log_predictive_probability(
    beta: np.ndarray,
    x_test: np.ndarray,
    alpha: float = 0.5,
    n_iters: int = 30,
) -> float:
    """Held-out per-token log predictive probability (paper's lpp metric).

    Fold-in: estimate θ_d on held-out docs by EM against fixed ``beta``
    (row-stochastic (K, V)), then score Σ n_dw log(θ_d·β_:,w) / Σ n_dw.
    """
    k = beta.shape[0]
    d = x_test.shape[0]
    if d == 0 or x_test.sum() == 0:
        return 0.0
    beta = np.maximum(beta, 1e-12)
    theta = np.full((d, k), 1.0 / k)
    for _ in range(n_iters):
        # E: responsibilities implicit via the normalizer
        mix = theta @ beta  # (D, V)
        ratio = x_test / np.maximum(mix, 1e-12)
        theta_new = theta * (ratio @ beta.T) + alpha
        theta = theta_new / theta_new.sum(axis=1, keepdims=True)
    mix = np.maximum(theta @ beta, 1e-12)
    total = float(x_test.sum())
    return float((x_test * np.log(mix)).sum() / total)
