"""Public wrappers of the Gibbs sweep kernels (``csrc/gibbs_sweep.cu``).

Source note.  ``gibbs_sweep`` replaces the Pallas kernel
``gibbs_sweep_pallas`` (``src/repro/kernels/gibbs_sweep/gibbs_sweep.py:88``)
and takes the argument layout of ``repro.kernels.gibbs_sweep.ops.
gibbs_sweep``.  ``cgs_sweep_exact`` is the counterpart of the jitted
``lax.scan`` ``_cgs_sweeps`` (``src/repro/core/gibbs.py:34``) — not a
Pallas kernel, but on the card its plain version would be tens of
thousands of tiny launches per sweep, so it has a kernel too.

Both are bound by latency, not by bytes or flops: every token's draw
depends on the previous one through the counts, so a sweep is a chain of
dependent steps, each a warp scan over the topics.  A chain runs on one
warp with the topics across its lanes; what a lane reads it alone
writes, so the chain needs no barrier, and a token's K-wide rows are
contiguous rows of (V, K) transposes, loaded while the token before it
draws.

- The blocked sweep reads, for a token, only its own document's n_kd
  row and the frozen snapshot, so each *document* is a chain: one warp
  a (block, document), its n_kd row in registers.  ``doc_index`` lists
  each document's real slots in slot order; ``core.gibbs`` builds it
  once per fit and ``gibbs_sweep`` builds it itself when none is given.
- The exact sweep is one warp over the whole token stream, the current
  document's n_kd row in registers.  ``cgs_sweep_exact_t`` takes n_kv
  and the global prior in that (V, K) layout, so ``core.gibbs.cgs_fit``
  transposes once per fit; ``cgs_sweep_exact`` keeps JAX's (K, V)
  arguments and transposes per call.

No padding of K, V, T or BD: the kernels mask the ragged edge
themselves.  K is at most 1024, the register budget of 32 topics a lane.
A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA
tensor goes to the kernel or raises.  ``gibbs_sweep_launches`` and
``cgs_sweep_exact_launches`` count kernel launches (one per sweep).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels.gibbs_sweep.ref import (
    cgs_sweep_exact_ref,
    gibbs_sweep_ref,
)

MAX_TOPICS = 1024              # the register budget: 32 lanes x 32 topics

gibbs_sweep_launches = 0
cgs_sweep_exact_launches = 0

DocIndex = Tuple[torch.Tensor, torch.Tensor]


def cost(n_blocks: int, t_max: int, bd: int, k: int, v: int,
         n_tokens: int) -> common.Cost:
    """One blocked sweep (``gibbs_sweep``) of ``n_blocks`` (B, T_max)
    token blocks of ``bd`` documents with ``n_tokens`` real tokens: the
    block inputs, n_kd in and out, the n_kv snapshot, z out and n_kv out
    once; ~8 operations per topic per real token (no products)."""
    return common.Cost(
        4 * (6 * n_blocks * t_max + 2 * n_blocks * bd * k + 2 * k * v + k),
        ((8 * k * n_tokens, common.PEAK_F32_FLOPS),))


def exact_cost(t: int, n_docs: int, k: int, v: int) -> common.Cost:
    """One exact sweep (``cgs_sweep_exact``) of a chain of ``t`` tokens
    over ``n_docs`` documents: the tokens, documents, uniforms and z in
    and out, n_kd, the (V, K) n_kv and prior and the topic totals once;
    ~10 operations per topic per token (no products)."""
    return common.Cost(4 * (5 * t + 2 * n_docs * k + 3 * k * v + 3 * k),
                       ((10 * k * t, common.PEAK_F32_FLOPS),))


def doc_index(ldoc: torch.Tensor, mask: torch.Tensor,
              block_docs: int) -> DocIndex:
    """The real slots of a blocked layout, grouped by document.

    ldoc/mask (B, T).  Returns ``(doc_ptr, slots)``, both int32 on
    ldoc's device: ``slots`` (B·T,) holds flat slot numbers b·T + t,
    document by document (g = b·BD + ldoc) and in slot order within
    each, the pad slots (mask 0) last; document g's slots are
    ``slots[doc_ptr[g]:doc_ptr[g + 1]]`` and ``doc_ptr`` is (B·BD + 1,).
    Any order of ``ldoc`` within a block is fine.  Torch index
    operations only (a stable sort and a ``searchsorted``), no sync.
    """
    b, t = ldoc.shape
    n_docs = b * block_docs
    dev = ldoc.device
    key = torch.arange(b, device=dev)[:, None] * block_docs + ldoc.long()
    key = torch.where(mask > 0, key, n_docs).reshape(-1)
    sorted_key, order = torch.sort(key, stable=True)
    doc_ptr = torch.searchsorted(
        sorted_key, torch.arange(n_docs + 1, device=dev))
    return doc_ptr.to(torch.int32), order.to(torch.int32)


def gibbs_sweep(words: torch.Tensor, ldoc: torch.Tensor, mask: torch.Tensor,
                u: torch.Tensor, z: torch.Tensor, nkd: torch.Tensor,
                prior: torch.Tensor, prior_k: torch.Tensor, alpha: float,
                doc_idx: Optional[DocIndex] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One doc-blocked CGS sweep.

    words/ldoc/z (B, T) int32 with ldoc in [0, BD), mask/u (B, T)
    float32 (mask 0 or 1), nkd (B, BD, K), prior (K, V) snapshot +
    global + β, prior_k (K,) its row sums (with Vβ).  ``doc_idx`` is
    ``doc_index(ldoc, mask, BD)``, built here when not given.  Returns
    (z', nkd', nkv (K, V)) with nkv the new assignments' counts summed
    over blocks.
    """
    if words.dim() != 2 or nkd.dim() != 3 or prior.dim() != 2:
        raise ValueError("words must be (B, T), nkd (B, BD, K), prior (K, V)")
    b, t = words.shape
    _, bd, k = nkd.shape
    v = prior.shape[1]
    for name, x in (("ldoc", ldoc), ("mask", mask), ("u", u), ("z", z)):
        if x.shape != (b, t):
            raise ValueError(f"{name} must be ({b}, {t}), got "
                             f"{tuple(x.shape)}")
    if nkd.shape[0] != b or prior.shape[0] != k or prior_k.shape != (k,):
        raise ValueError(f"nkd {tuple(nkd.shape)}, prior "
                         f"{tuple(prior.shape)} and prior_k "
                         f"{tuple(prior_k.shape)} disagree on B or K")
    dev = common.same_device(words=words, ldoc=ldoc, mask=mask, u=u, z=z,
                             nkd=nkd, prior=prior, prior_k=prior_k)
    if dev.type == "cpu":
        return gibbs_sweep_ref(words, ldoc, mask, u, z, nkd, prior, prior_k,
                               alpha)
    for name, x in (("words", words), ("ldoc", ldoc), ("z", z)):
        common.require_cuda(name, x, dev, torch.int32)
    for name, x in (("mask", mask), ("u", u), ("nkd", nkd),
                    ("prior", prior), ("prior_k", prior_k)):
        common.require_cuda(name, x, dev)
    if not 1 <= k <= MAX_TOPICS or b * t >= 2 ** 31:
        raise ValueError(
            f"gibbs_sweep kernel takes 1 <= K <= {MAX_TOPICS} (32 topics "
            f"a lane) and B*T < 2^31 slots; got K={k}, B*T={b * t}")
    doc_ptr, slots = doc_idx if doc_idx is not None \
        else doc_index(ldoc, mask, bd)
    if doc_ptr.shape != (b * bd + 1,) or slots.shape != (b * t,):
        raise ValueError(f"doc_idx must be ({b * bd + 1},) and ({b * t},), "
                         f"got {tuple(doc_ptr.shape)} and "
                         f"{tuple(slots.shape)}")
    common.require_cuda("doc_ptr", doc_ptr, dev, torch.int32)
    common.require_cuda("slots", slots, dev, torch.int32)
    prior_t = prior.t().contiguous()
    z_out = z.clone()                      # pad slots keep their topic
    nkd_out = torch.empty_like(nkd)
    nkv = torch.zeros((k, v), dtype=torch.float32, device=dev)
    common.launch(
        "gibbs_sweep", "mlego_gibbs_sweep_blocked", dev,
        words, mask, u, z, doc_ptr, slots, nkd, prior_t, prior_k, z_out,
        nkd_out, nkv, b * bd, k, v, float(alpha),
        common.stream_of(words))
    common.count_launch(globals(), "gibbs_sweep_launches")
    return z_out, nkd_out, nkv


def cgs_sweep_exact_t(tokens: torch.Tensor, doc_ids: torch.Tensor,
                      u: torch.Tensor, z: torch.Tensor, nkd: torch.Tensor,
                      nkv_t: torch.Tensor, nk: torch.Tensor,
                      g_t: torch.Tensor, gk: torch.Tensor,
                      alpha: float, beta: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """:func:`cgs_sweep_exact` with n_kv and the global prior in the
    kernel's (V, K) layout: nkv_t and g_t (V, K).  Returns
    (z', nkd', nkv_t' (V, K), nk')."""
    if tokens.dim() != 1 or nkd.dim() != 2 or nkv_t.dim() != 2 \
            or g_t.shape != nkv_t.shape:
        raise ValueError(f"tokens must be (T,), nkd (D, K), nkv_t and g_t "
                         f"one (V, K) shape; got {tuple(tokens.shape)}, "
                         f"{tuple(nkd.shape)}, {tuple(nkv_t.shape)}, "
                         f"{tuple(g_t.shape)}")
    t = tokens.shape[0]
    v, k = nkv_t.shape
    for name, x in (("doc_ids", doc_ids), ("u", u), ("z", z)):
        if x.shape != (t,):
            raise ValueError(f"{name} must be ({t},), got {tuple(x.shape)}")
    if nkd.shape[1] != k or nk.shape != (k,) or gk.shape != (k,):
        raise ValueError(f"nkd {tuple(nkd.shape)}, nk {tuple(nk.shape)} and "
                         f"gk {tuple(gk.shape)} disagree with K={k}")
    dev = common.same_device(tokens=tokens, doc_ids=doc_ids, u=u, z=z,
                             nkd=nkd, nkv_t=nkv_t, nk=nk, g_t=g_t, gk=gk)
    if dev.type == "cpu":
        z, nkd, nkv, nk = cgs_sweep_exact_ref(
            tokens, doc_ids, u, z, nkd, nkv_t.t(), nk, g_t.t(), gk, alpha,
            beta)
        return z, nkd, nkv.t().contiguous(), nk
    for name, x in (("tokens", tokens), ("doc_ids", doc_ids), ("z", z)):
        common.require_cuda(name, x, dev, torch.int32)
    for name, x in (("u", u), ("nkd", nkd), ("nkv_t", nkv_t), ("nk", nk),
                    ("g_t", g_t), ("gk", gk)):
        common.require_cuda(name, x, dev)
    if not 1 <= k <= MAX_TOPICS or t < 1:
        raise ValueError(f"cgs_sweep_exact kernel takes 1 <= K <= "
                         f"{MAX_TOPICS} (32 topics a lane) and T >= 1; got "
                         f"K={k}, T={t}")
    # the kernel updates these in place
    z_out, nkd_out, nkv_out, nk_out = (x.clone() for x in (z, nkd, nkv_t, nk))
    # V·β rounded in float32, as JAX forms it from the traced β
    vbeta = float(np.float32(v) * np.float32(beta))
    common.launch(
        "cgs_sweep_exact", "mlego_gibbs_sweep_exact", dev,
        tokens, doc_ids, u, z_out, nkd_out, nkv_out, nk_out, g_t, gk, t, k,
        float(alpha), float(beta), vbeta, common.stream_of(tokens))
    common.count_launch(globals(), "cgs_sweep_exact_launches")
    return z_out, nkd_out, nkv_out, nk_out


def cgs_sweep_exact(tokens: torch.Tensor, doc_ids: torch.Tensor,
                    u: torch.Tensor, z: torch.Tensor, nkd: torch.Tensor,
                    nkv: torch.Tensor, nk: torch.Tensor,
                    global_nkv: torch.Tensor, gk: torch.Tensor,
                    alpha: float, beta: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """One exact CGS sweep over a partition's token stream.

    tokens/doc_ids/z (T,) int32, u (T,) float32, nkd (D, K), nkv (K, V)
    local counts, nk (K,) their row sums, global_nkv (K, V) the DSGS prior
    and gk (K,) its row sums.  Returns (z', nkd', nkv', nk').
    """
    if nkv.dim() != 2 or global_nkv.shape != nkv.shape:
        raise ValueError(f"nkv {tuple(nkv.shape)} and global_nkv "
                         f"{tuple(global_nkv.shape)} must be one (K, V) "
                         f"shape")
    z, nkd, nkv_t, nk = cgs_sweep_exact_t(
        tokens, doc_ids, u, z, nkd, nkv.t().contiguous(), nk,
        global_nkv.t().contiguous(), gk, alpha, beta)
    return z, nkd, nkv_t.t().contiguous(), nk
