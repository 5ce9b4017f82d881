"""Plain PyTorch versions of the two collapsed-Gibbs sweeps (Eq. 7–9).

``gibbs_sweep_ref`` is one *doc-blocked* sweep: every doc block resamples
its tokens in order against a frozen per-sweep snapshot of the
topic-word counts (``prior`` = local n_kv + global N_kv + β) while its
document-topic counts ``n_kd`` stay exact (documents never span blocks).
It is vectorised over blocks and loops over token slots, as the JAX
package's ``src/repro/kernels/gibbs_sweep/ref.py:26-79`` does.

``cgs_sweep_exact_ref`` is one sweep of the *exact* token scan, the body
of ``_cgs_sweeps`` (``src/repro/core/gibbs.py:53-73``): counts are live,
and each token's conditional

    p_k = (n_kd[d,k] + α)(n_kv[k,w] + g[k,w] + β) / (n_k + g_k + Vβ)

is computed afresh from the integer counts with that token taken out.

Both draw ``new = #{k : c_k < u·c_{K−1}}`` (``searchsorted`` on the left,
clipped to K−1) from the running sum ``c`` of the conditional.  The order
of that sum decides the rare draw whose target lands within a rounding
step of some ``c_k``, and one such flip changes every later draw of its
chain.  So ``_cumsum`` follows the implementation the plain version is
held against: on the CPU it adds left to right in float32, the order
JAX's CPU lowering uses at the test widths (torch's CPU cumsum
accumulates in double); on the card it adds in the kernels' warp-scan
order (``_warp_cumsum``), so kernel and plain version agree bit for bit.

Each token loop is written once, in operations that torch tensors and
numpy arrays share.  For CPU tensors it runs on numpy views of them:
one small numpy operation costs about a microsecond and one torch
operation about ten, and a sweep is tens of thousands of such steps.
The arithmetic is the same float32 either way.

The wrappers in ``ops.py`` run these only for CPU tensors; on the card
they are what the kernels are held against.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _cumsum(p):
    """Running sum over the last axis: left to right in float32 on the
    CPU (numpy), in the kernels' order on the card."""
    if isinstance(p, np.ndarray):
        return np.cumsum(p, axis=-1, dtype=np.float32)
    return _warp_cumsum(p)


def _warp_cumsum(p: torch.Tensor) -> torch.Tensor:
    """Running sum over the last axis in the order of ``draw_topic`` in
    ``csrc/gibbs_sweep.cu``: lane l of a warp sums its KPL topics
    [l·KPL, (l+1)·KPL) left to right, a Hillis–Steele scan runs over the
    32 lane totals, and lanes l > 0 add the total of lanes < l."""
    k = p.shape[-1]
    kpl = 1
    while kpl * 32 < k:
        kpl *= 2
    lanes = torch.nn.functional.pad(p, (0, 32 * kpl - k)).reshape(
        *p.shape[:-1], 32, kpl)
    cols = [lanes[..., 0]]
    for j in range(1, kpl):
        cols.append(cols[-1] + lanes[..., j])
    local = torch.stack(cols, dim=-1)
    incl = local[..., -1]
    for off in (1, 2, 4, 8, 16):
        incl = torch.cat([incl[..., :off], incl[..., off:] + incl[..., :-off]],
                         dim=-1)
    c = torch.cat([local[..., :1, :],
                   local[..., 1:, :] + incl[..., :-1, None]], dim=-2)
    return c.reshape(*p.shape[:-1], 32 * kpl)[..., :k]


def _draw(p, u):
    """Inverse-CDF draw per row of p (..., K) with uniforms u (...)."""
    c = _cumsum(p)
    return (c < (u * c[..., -1])[..., None]).sum(-1).clip(max=p.shape[-1] - 1)


def _host(t: torch.Tensor):
    """A numpy view of a CPU tensor (same storage); CUDA tensors as is."""
    return t.numpy() if t.device.type == "cpu" else t


def gibbs_sweep_ref(words: torch.Tensor, ldoc: torch.Tensor,
                    mask: torch.Tensor, u: torch.Tensor, z: torch.Tensor,
                    nkd: torch.Tensor, prior: torch.Tensor,
                    prior_k: torch.Tensor, alpha: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One blocked CGS sweep over all doc blocks.

    words/ldoc/z (B, T) int32, mask/u (B, T) float32, nkd (B, BD, K),
    prior (K, V) snapshot + global + β, prior_k (K,) its row sums (with
    Vβ).  Returns (z', nkd', nkv) with nkv (K, V) the token counts of the
    *new* assignments summed over blocks.  Pad slots (mask 0) keep their
    topic.
    """
    b, t = words.shape
    k, v = prior.shape
    dev = words.device
    z_out, nkd_out = z.clone(), nkd.clone()
    zw, nkdw, wd, ld, mk, uu, pt, pk = map(
        _host, (z_out, nkd_out, words, ldoc, mask, u, prior.t(), prior_k))
    if dev.type == "cpu":
        kidx, rows = np.arange(k), np.arange(b)
    else:
        kidx, rows = torch.arange(k, device=dev), torch.arange(b, device=dev)
    for i in range(t):
        w, d, m, old = wd[:, i], ld[:, i], mk[:, i], zw[:, i]
        oh_old = (kidx == old[:, None]) * m[:, None]
        nd = nkdw[rows, d] - oh_old                # exact doc-topic counts
        num = pt[w] - oh_old                       # stale n_kv, own token out
        den = pk - oh_old
        p = (nd + alpha) * num / den               # Eq. 7 with the DSGS prior
        real = m > 0
        new = _draw(p, uu[:, i]) * real + old * ~real
        oh_new = (kidx == new[:, None]) * m[:, None]
        nkdw[rows, d] = nkdw[rows, d] + (oh_new - oh_old)
        zw[:, i] = new
    nkv = torch.zeros((k, v), dtype=torch.float32, device=dev)
    nkv.index_put_((z_out.reshape(-1).long(), words.reshape(-1).long()),
                   mask.reshape(-1), accumulate=True)
    return z_out, nkd_out, nkv


def cgs_sweep_exact_ref(tokens: torch.Tensor, doc_ids: torch.Tensor,
                        u: torch.Tensor, z: torch.Tensor, nkd: torch.Tensor,
                        nkv: torch.Tensor, nk: torch.Tensor,
                        global_nkv: torch.Tensor, gk: torch.Tensor,
                        alpha: float, beta: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """One exact CGS sweep over a token stream, counts live.

    tokens/doc_ids/z (T,) int32, u (T,) float32, nkd (D, K), nkv (K, V)
    local counts, nk (K,) their row sums, global_nkv (K, V) the DSGS
    prior and gk (K,) its row sums.  Returns (z', nkd', nkv', nk').
    """
    k, vocab = nkv.shape
    # V·β rounded in float32, as JAX forms it from the traced β
    vbeta = float(np.float32(vocab) * np.float32(beta))
    out = [x.clone() for x in (nkd, nkv, nk)]
    cnt_d, cnt_v, cnt_k, g, g_k, uu = map(_host, (*out, global_nkv, gk, u))
    topics = z.tolist()
    for i, (w, d, old) in enumerate(zip(tokens.tolist(), doc_ids.tolist(),
                                        topics)):
        cnt_d[d, old] -= 1.0
        cnt_v[old, w] -= 1.0
        cnt_k[old] -= 1.0
        p = (cnt_d[d] + alpha) * (cnt_v[:, w] + g[:, w] + beta) / (
            cnt_k + g_k + vbeta)
        new = int(_draw(p, uu[i]))
        topics[i] = new
        cnt_d[d, new] += 1.0
        cnt_v[new, w] += 1.0
        cnt_k[new] += 1.0
    z_out = torch.tensor(topics, dtype=z.dtype, device=z.device)
    return (z_out, *out)
