"""Collapsed Gibbs Sampling for LDA + DSGS partition deltas (paper Eq. 7–9).

The exact token sweep is sequential (each draw conditions on all other
assignments): ``cgs_fit`` runs it one sweep at a time through
``kernels.gibbs_sweep.cgs_sweep_exact_t`` — on the card one launch of the
exact-scan kernel per sweep, on the CPU its plain version — keeping n_kv
and the global prior in the kernel's (V, K) layout for the whole fit
(one transpose in, one out).  Distribution
comes from *partitioning*: each worker runs CGS on its partition against
a fixed global ``N_kv`` prior (Eq. 8) and emits ``ΔN_kv``; merging
deltas (Alg. 2) is a reduction.

``cgs_fit_blocked`` applies the same fixed-prior independence one level
down: documents are split into *doc blocks*, each block keeps its
``n_kd`` exact and resamples its tokens in order against a per-sweep
snapshot of ``n_kv + global N_kv``, and the blocks' new counts are
summed between sweeps (``kernels.gibbs_sweep.gibbs_sweep``).  Since a
token reads only its own document's counts and the frozen snapshot, the
kernel runs one chain per document (the per-document index is built once
per fit): the chain per sweep shrinks from Σ tokens to the most tokens of
any document.  It is
the device backend's gap trainer; ``cgs_fit`` is the exact reference
(and the host backend's trainer).

Randomness comes from an explicit ``torch.Generator``; both fits run on
``gen.device``.  ``z0=`` and ``u=`` inject the initial assignments and
every sweep's uniforms, so a test can hand the JAX and PyTorch samplers
the same draws.  The per-sweep snapshot stays plain torch, in JAX's
order of operations.
"""
from __future__ import annotations

import math
from contextlib import nullcontext
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.lda_default import LDAConfig
from repro_torch.kernels.gibbs_sweep.ops import (
    cgs_sweep_exact_t,
    doc_index,
    gibbs_sweep,
)
from repro_torch.obs import trace as obs

ArrayLike = Union[np.ndarray, torch.Tensor]


def _vocab(cfg: LDAConfig, global_nkv) -> int:
    return cfg.vocab_size if global_nkv is None else global_nkv.shape[1]


def _as(x: ArrayLike, dtype: torch.dtype, dev: torch.device
        ) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.to(dev, dtype).contiguous()


def _global(cfg: LDAConfig, global_nkv: Optional[ArrayLike], vocab: int,
            dev: torch.device) -> torch.Tensor:
    if global_nkv is None:
        return torch.zeros((cfg.n_topics, vocab), dtype=torch.float32,
                           device=dev)
    return _as(global_nkv, torch.float32, dev)


def _draws(u: Optional[ArrayLike], sweeps: int, shape: Tuple[int, ...],
           gen: torch.Generator, dev: torch.device):
    """One (shape) array of uniforms per sweep, injected or drawn."""
    if u is not None:
        u = _as(u, torch.float32, dev)
        if u.shape != (sweeps,) + shape:
            raise ValueError(f"u must be {(sweeps,) + shape}, got "
                             f"{tuple(u.shape)}")
    for s in range(sweeps):
        yield u[s] if u is not None else torch.rand(
            shape, generator=gen, device=dev, dtype=torch.float32)


def _init_z(z0: Optional[ArrayLike], shape: Tuple[int, ...], k: int,
            gen: torch.Generator, dev: torch.device) -> torch.Tensor:
    if z0 is None:
        return torch.randint(0, k, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    z = _as(z0, torch.int32, dev)
    if z.shape != shape:
        raise ValueError(f"z0 must be {shape}, got {tuple(z.shape)}")
    return z


def cgs_fit(tokens: np.ndarray, doc_ids: np.ndarray, cfg: LDAConfig,
            gen: torch.Generator, global_nkv: Optional[ArrayLike] = None,
            sweeps: Optional[int] = None, *,
            z0: Optional[ArrayLike] = None,
            u: Optional[ArrayLike] = None) -> torch.Tensor:
    """Train a CGS partition model with the exact token scan.  Returns
    ΔN_kv (K, V) float32 on ``gen.device``.

    With ``global_nkv`` provided this is one DSGS step (Eq. 8):
    ΔN_kv = CGS(α, β + N_kv, W^t).  ``z0`` (T,) and ``u`` (sweeps, T)
    replace the generator's draws.
    """
    dev = gen.device
    vocab = _vocab(cfg, global_nkv)
    k = cfg.n_topics
    if tokens.size == 0:
        return torch.zeros((k, vocab), dtype=torch.float32, device=dev)
    sweeps = sweeps if sweeps is not None else cfg.gibbs_sweeps
    gnkv = _global(cfg, global_nkv, vocab, dev)
    n_docs = int(doc_ids.max()) + 1
    toks = _as(tokens, torch.int32, dev)
    docs = _as(doc_ids, torch.int32, dev)
    z = _init_z(z0, (toks.shape[0],), k, gen, dev)
    ones = torch.ones(toks.shape[0], dtype=torch.float32, device=dev)
    zl, dl, tl = z.long(), docs.long(), toks.long()
    nkd = torch.zeros((n_docs, k), dtype=torch.float32, device=dev)
    nkd.index_put_((dl, zl), ones, accumulate=True)
    # n_kv and the prior in the kernel's (V, K) layout for every sweep
    nkv_t = torch.zeros((vocab, k), dtype=torch.float32, device=dev)
    nkv_t.index_put_((tl, zl), ones, accumulate=True)
    nk = torch.zeros((k,), dtype=torch.float32, device=dev)
    nk.index_put_((zl,), ones, accumulate=True)
    gk = gnkv.sum(dim=1)
    g_t = gnkv.t().contiguous()
    for us in _draws(u, sweeps, (toks.shape[0],), gen, dev):
        z, nkd, nkv_t, nk = cgs_sweep_exact_t(toks, docs, us, z, nkd, nkv_t,
                                              nk, g_t, gk, cfg.alpha,
                                              cfg.eta)
    return nkv_t.t().contiguous()


# ---------------------------------------------------------------------------
# doc-blocked sweeps (device route; kernels/gibbs_sweep)
# ---------------------------------------------------------------------------

def blocked_layout(tokens: np.ndarray, doc_ids: np.ndarray, n_docs: int,
                   block_docs: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack a CSR-ordered token stream into (n_blocks, T) doc blocks.

    Block b owns the contiguous documents [b·BD, (b+1)·BD); its tokens
    are a contiguous ``doc_ids`` slice (the stream is sorted by doc).
    Returns ``(words, ldoc, mask)`` each (n_blocks, T) with T the
    widest block's token count — pad slots carry mask 0 and word/doc 0.
    """
    n_blocks = max(1, math.ceil(n_docs / block_docs))
    edges = np.searchsorted(
        doc_ids, np.arange(n_blocks + 1) * block_docs, side="left")
    t_max = max(1, int(np.diff(edges).max()))
    words = np.zeros((n_blocks, t_max), np.int32)
    ldoc = np.zeros((n_blocks, t_max), np.int32)
    mask = np.zeros((n_blocks, t_max), np.float32)
    for b in range(n_blocks):
        t0, t1 = int(edges[b]), int(edges[b + 1])
        n = t1 - t0
        words[b, :n] = tokens[t0:t1]
        ldoc[b, :n] = doc_ids[t0:t1] - b * block_docs
        mask[b, :n] = 1.0
    return words, ldoc, mask


def _blocked_sweeps(words: torch.Tensor, ldoc: torch.Tensor,
                    mask: torch.Tensor, gen: torch.Generator,
                    global_nkv: torch.Tensor, n_topics: int,
                    block_docs: int, sweeps: int, alpha: float, beta: float,
                    z0: Optional[ArrayLike], u: Optional[ArrayLike]
                    ) -> torch.Tensor:
    """Run ``sweeps`` blocked sweeps.  Returns the final local n_kv."""
    dev = words.device
    b, t = words.shape
    vocab = global_nkv.shape[1]
    with obs.span("train.fit", "train", sweeps=sweeps):
        z = _init_z(z0, (b, t), n_topics, gen, dev)
        nkd = torch.zeros((b, block_docs, n_topics), dtype=torch.float32,
                          device=dev)
        blk = torch.arange(b, device=dev)[:, None].expand(b, t)
        nkd.index_put_((blk.reshape(-1), ldoc.reshape(-1).long(),
                        z.reshape(-1).long()), mask.reshape(-1),
                       accumulate=True)
        nkv = torch.zeros((n_topics, vocab), dtype=torch.float32, device=dev)
        nkv.index_put_((z.reshape(-1).long(), words.reshape(-1).long()),
                       mask.reshape(-1), accumulate=True)
        gk = global_nkv.sum(dim=1)
        idx = doc_index(ldoc, mask, block_docs)      # once per fit
        for us in _draws(u, sweeps, (b, t), gen, dev):
            prior = nkv + global_nkv + beta           # frozen for this sweep
            prior_k = nkv.sum(dim=1) + gk + vocab * beta
            z, nkd, nkv = gibbs_sweep(words, ldoc, mask, us, z, nkd, prior,
                                      prior_k, alpha, idx)
    return nkv


def cgs_fit_blocked(tokens: np.ndarray, doc_ids: np.ndarray, cfg: LDAConfig,
                    gen: torch.Generator,
                    global_nkv: Optional[ArrayLike] = None,
                    sweeps: Optional[int] = None, *, block_docs: int = 64,
                    z0: Optional[ArrayLike] = None,
                    u: Optional[ArrayLike] = None) -> torch.Tensor:
    """Doc-blocked CGS partition model.  Returns ΔN_kv (K, V) float32 on
    ``gen.device``.

    Same contract as :func:`cgs_fit` (a DSGS step when ``global_nkv``
    is given) but sampled with the blocked sweep: per-sweep-stale
    ``n_kv`` across doc blocks, exact ``n_kd`` within each.  Not
    bit-comparable to the exact scan — parity is *statistical*.
    ``z0`` (n_blocks, T) and ``u`` (sweeps, n_blocks, T) replace the
    generator's draws, in :func:`blocked_layout`'s layout.
    """
    dev = gen.device
    vocab = _vocab(cfg, global_nkv)
    if tokens.size == 0:
        return torch.zeros((cfg.n_topics, vocab), dtype=torch.float32,
                           device=dev)
    with (obs.span("train.upload", "train",
                   bytes=4 * cfg.n_topics * vocab)
          if global_nkv is not None else nullcontext()):
        gnkv = _global(cfg, global_nkv, vocab, dev)
    with obs.span("train.layout", "train", tokens=int(tokens.size)):
        if np.any(np.diff(doc_ids) < 0):
            # blocked_layout needs the CSR doc-sorted stream cgs_fit does
            # not; token order within a doc is immaterial to the sampler
            order = np.argsort(doc_ids, kind="stable")
            tokens, doc_ids = tokens[order], doc_ids[order]
        n_docs = int(doc_ids.max()) + 1
        words, ldoc, mask = blocked_layout(tokens, doc_ids, n_docs,
                                           block_docs)
        obs.set_attrs(docs=n_docs, blocks=words.shape[0],
                      t_max=words.shape[1])
    with obs.span("train.upload", "train",
                  bytes=words.nbytes + ldoc.nbytes + mask.nbytes):
        layout = (_as(words, torch.int32, dev), _as(ldoc, torch.int32, dev),
                  _as(mask, torch.float32, dev))
    return _blocked_sweeps(
        *layout, gen, gnkv, cfg.n_topics, block_docs,
        sweeps if sweeps is not None else cfg.gibbs_sweeps,
        cfg.alpha, cfg.eta, z0, u)
