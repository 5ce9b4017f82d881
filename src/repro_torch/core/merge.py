"""Model merging — the paper's Alg. 1 (MVB) and Alg. 2 (MGS).

Both merges are exponential-family natural-parameter additions, i.e.
**reductions**: order-independent, associative, O(x·K·V).  On the mesh
they run as all-reduces; here is the host/NumPy form used by the
planner and the model store, plus the parameters of the device form
the CUDA ``merge_topics`` kernel computes.

MVB (weighted SDA-Bayes, Eq. 6):   λ* = η + Σ_i w_i (λ_i − η)
MGS (weighted DSGS,      Eq. 9):   N*_kv = Σ_i decay^{s_i} ΔN_kv^i

``s_i`` is the *staleness rank* of model i (0 = freshest).  With all
models equally fresh (the plan-merge case) every s_i = 0 and the merge
is exactly order-independent; the decay path is the streaming /
straggler-mitigation policy (bounded staleness).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.lda_default import LDAConfig
from repro_torch.core.lda import MaterializedModel, topics_from_gs, topics_from_vb


def merge_vb(models: Sequence[MaterializedModel], cfg: LDAConfig,
             weights: Optional[Sequence[float]] = None) -> np.ndarray:
    """Alg. 1 — returns merged λ (K, V)."""
    if not models:
        raise ValueError("nothing to merge")
    w = np.ones(len(models)) if weights is None else np.asarray(weights, float)
    lam = np.full_like(models[0].lam, cfg.eta)
    for wi, m in zip(w, models):
        lam = lam + wi * (m.lam - cfg.eta)          # Δλ_i = λ_i − λ_0
    return lam


def merge_gs(models: Sequence[MaterializedModel], cfg: LDAConfig,
             staleness: Optional[Sequence[int]] = None,
             decay: Optional[float] = None) -> np.ndarray:
    """Alg. 2 — returns merged N_kv (K, V).

    ``staleness[i]`` = s_i ≥ 0; ``decay`` defaults to cfg.decay but is
    only applied where s_i > 0 (plan merges pass no staleness and are
    exactly order-independent).
    """
    if not models:
        raise ValueError("nothing to merge")
    d = cfg.decay if decay is None else decay
    s = [0] * len(models) if staleness is None else list(staleness)
    nkv = np.zeros_like(models[0].delta_nkv)
    for si, m in zip(s, models):
        nkv = nkv + (d ** si) * m.delta_nkv
    return nkv


def merge_models(models: Sequence[MaterializedModel], cfg: LDAConfig,
                 **kw) -> np.ndarray:
    """Merge a homogeneous model list; returns the topic matrix β (K, V)."""
    kinds = {m.kind for m in models}
    if len(kinds) != 1:
        raise ValueError(f"cannot merge mixed kinds {kinds}")
    if kinds == {"vb"}:
        return topics_from_vb(merge_vb(models, cfg, **kw))
    return topics_from_gs(merge_gs(models, cfg, **kw), cfg.eta)


def merged_theta(models: Sequence[MaterializedModel], cfg: LDAConfig):
    """Merged Θ in materializable form (for re-materializing query results)."""
    kind = models[0].kind
    if kind == "vb":
        return {"lam": merge_vb(models, cfg)}, "vb"
    return {"delta_nkv": merge_gs(models, cfg)}, "gs"


# ---------------------------------------------------------------------------
# device form — how each built-in family maps onto the fused
# ``kernels/merge_topics`` reduction  out = bias + Σ w_i (stat_i − base)
# ---------------------------------------------------------------------------

DEVICE_MERGE_FAMILIES = ("vb", "gs")

_DEVICE_STAT_KEYS = {"vb": "lam", "gs": "delta_nkv"}


def device_stat_key(kind: str) -> str:
    """Θ entry that is the merge statistic for a device family
    (cfg-free subset of :func:`device_merge_params`)."""
    try:
        return _DEVICE_STAT_KEYS[kind]
    except KeyError:
        raise KeyError(f"kind {kind!r} has no device merge form "
                       f"(one of {DEVICE_MERGE_FAMILIES})") from None


def device_merge_params(kind: str, cfg: LDAConfig):
    """(stat_key, bias, base, finisher) for a kernel-mergeable kind.

    ``stat_key`` names the Θ entry that is the merge statistic;
    ``finisher`` maps the merged statistic to the topic matrix β —
    the same function the host merge families apply, so host/device
    parity is exact up to the reduction's float ordering.
    """
    if kind == "vb":
        return "lam", cfg.eta, cfg.eta, topics_from_vb
    if kind == "gs":
        return "delta_nkv", 0.0, 0.0, (
            lambda nkv: topics_from_gs(nkv, cfg.eta))
    raise KeyError(f"kind {kind!r} has no device merge form "
                   f"(one of {DEVICE_MERGE_FAMILIES})")


def device_norm_offset(kind: str, cfg: LDAConfig) -> float:
    """Finisher numerator offset for *device-side* normalization.

    Both finishers are ``(merged + offset) / rowsum(merged + offset)``:
    vb normalizes λ directly (offset 0) and gs smooths first —
    ``topics_from_gs`` divides ``nkv + η`` by ``rowsum(nkv) + V·η``,
    which is exactly the row sum of the offset numerator.  That shared
    shape is what lets the vocab-sharded merge normalize on device with
    a single (K,) psum instead of gathering the merged statistic.
    """
    if kind == "vb":
        return 0.0
    if kind == "gs":
        return cfg.eta
    raise KeyError(f"kind {kind!r} has no device merge form "
                   f"(one of {DEVICE_MERGE_FAMILIES})")
