"""Recurrent sequence mixers: mLSTM and sLSTM (xLSTM), RG-LRU (Griffin).

The port of ``src/repro/models/recurrent.py``'s single-device paths, and
of the two final-state helpers of ``src/repro/models/model.py:832,848``.
The mLSTM and the RG-LRU are plain torch, as they are plain jnp in JAX,
and differentiate as they stand.  The sLSTM recurrence runs the scan
kernel (``kernels/slstm_scan``) in prefill and decode alike; on a CPU
tensor the kernel's wrapper takes its plain version.  The training path
(``Model.loss``) runs ``slstm_train``, JAX's float32 step loop under
autograd: the kernel's output carries no gradient.

Same numerical conventions as the JAX module (documented simplifications
of arXiv:2405.04517): the mLSTM input gate is log-sigmoid (bounded), the
sLSTM keeps exponential gating with the (c, n, m) stabiliser state.

Waiting for ROADMAP.md Queue 1 item 6 (the ring over ranks): the
exclusive ring prefix and the ``shard_map`` branches; on one device they
are the identity.

Where JAX contracts three operands in one ``einsum``
(``"blhd,blhv,blh->bhdv"``), the port first folds the weights into k and
then contracts two: without ``opt_einsum``, torch would contract left to
right through a (B, S, H, hd, hd) float32 intermediate.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.kernels.slstm_scan.ref import State, logsig, zero_state

MLSTM_CHUNK = 256


# ===========================================================================
# mLSTM
# ===========================================================================

def _mlstm_chunk_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      logi: torch.Tensor, logf: torch.Tensor,
                      c0: torch.Tensor, n0: torch.Tensor, chunk: int
                      ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                      torch.Tensor]]:
    """Chunked-parallel mLSTM over a sequence.

    q, k, v: (B, S, H, hd) float32; logi, logf: (B, S, H) float32 (log
    gates, <= 0); c0: (B, H, hd, hd); n0: (B, H, hd).  Returns h
    (B, S, H, hd) and the final (C, n)."""
    b, s, h, hd = q.shape
    L = chunk
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    C, nv = c0, n0
    outs = []
    for c in range(s // L):
        sl = slice(c * L, (c + 1) * L)
        qc, kc, vc, li, lf = q[:, sl], k[:, sl], v[:, sl], logi[:, sl], \
            logf[:, sl]
        cum = torch.cumsum(lf, dim=1)                       # (B, L, H)
        dec = torch.exp(cum)[..., None]                     # (B, L, H, 1)
        qdec = qc * dec
        h_inter = torch.einsum("blhd,bhdv->blhv", qdec, C)
        qn_inter = torch.einsum("blhd,bhd->blh", qdec, nv)
        # intra-chunk decay-weighted scores
        diff = cum[:, :, None, :] - cum[:, None, :, :] + li[:, None, :, :]
        w = torch.exp(torch.where(tri[None, :, :, None], diff,
                                  torch.full_like(diff, -torch.inf)))
        scores = torch.einsum("bthd,bshd->btsh", qc, kc) * w
        h_intra = torch.einsum("btsh,bshv->bthv", scores, vc)
        qn = qn_inter + scores.sum(dim=2)
        outs.append((h_inter + h_intra)
                    / torch.clamp(qn.abs(), min=1.0)[..., None])
        # carry update
        dend = torch.exp(cum[:, -1])                        # (B, H)
        wend = torch.exp(cum[:, -1:, :] - cum + li)         # (B, L, H)
        kw = kc * wend[..., None]
        C = dend[..., None, None] * C + torch.einsum("blhd,blhv->bhdv", kw,
                                                     vc)
        nv = dend[..., None] * nv + kw.sum(dim=1)
    return torch.cat(outs, dim=1), (C, nv)


def mlstm_seq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              i_raw: torch.Tensor, f_raw: torch.Tensor, *,
              chunk: int = MLSTM_CHUNK) -> torch.Tensor:
    """mLSTM over a sequence from the zero state.

    q, k, v: (B, S, H, hd); i_raw, f_raw: (B, S, H).  Returns h
    (B, S, H, hd) in q's dtype, computed in float32 in chunks of
    L = the largest divisor of S that is at most ``chunk``."""
    b, s, h, hd = q.shape
    scale = hd ** -0.5
    qf = q.float() * scale
    kf = k.float() * scale
    vf = v.float()
    logi = logsig(i_raw.float())
    logf = logsig(f_raw.float())
    L = min(chunk, s)
    while s % L:
        L -= 1
    c0 = q.new_zeros((b, h, hd, hd), dtype=torch.float32)
    n0 = q.new_zeros((b, h, hd), dtype=torch.float32)
    hs, _ = _mlstm_chunk_scan(qf, kf, vf, logi, logf, c0, n0, L)
    return hs.to(q.dtype)


def mlstm_decode_step(state: Tuple[torch.Tensor, torch.Tensor],
                      q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      i_raw: torch.Tensor, f_raw: torch.Tensor
                      ) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                                 torch.Tensor]:
    """One decode step.  state = (C (B, H, hd, hd), n (B, H, hd));
    q, k, v: (B, H, hd); i_raw, f_raw: (B, H).  Returns the new state and
    h (B, H, hd) in q's dtype."""
    C, nv = state
    hd = q.shape[-1]
    qf = q.float() * (hd ** -0.5)
    kf = k.float() * (hd ** -0.5)
    vf = v.float()
    i_g = torch.exp(logsig(i_raw.float()))[..., None]
    f_g = torch.exp(logsig(f_raw.float()))[..., None]
    C = f_g[..., None] * C + i_g[..., None] * (kf[..., :, None]
                                               * vf[..., None, :])
    nv = f_g * nv + i_g * kf
    qn = torch.einsum("bhd,bhd->bh", qf, nv)
    h = torch.einsum("bhd,bhdv->bhv", qf, C) \
        / torch.clamp(qn.abs(), min=1.0)[..., None]
    return (C, nv), h.to(q.dtype)


def mlstm_with_state(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     i_raw: torch.Tensor, f_raw: torch.Tensor
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                    torch.Tensor]]:
    """``mlstm_seq`` and the final (C, n) for the prefill-to-decode
    handoff, the state recomputed from the whole sequence's summaries as
    JAX's ``_mlstm_with_state`` does."""
    out = mlstm_seq(q, k, v, i_raw, f_raw)
    hd = q.shape[-1]
    kf = k.float() * (hd ** -0.5)
    vf = v.float()
    logi = logsig(i_raw.float())
    logf = logsig(f_raw.float())
    cum = torch.cumsum(logf, dim=1)
    wend = torch.exp(cum[:, -1:, :] - cum + logi)           # (B, S, H)
    kw = kf * wend[..., None]
    cT = torch.einsum("bshd,bshv->bhdv", kw, vf)
    nT = kw.sum(dim=1)
    return out, (cT, nT)


# ===========================================================================
# sLSTM
# ===========================================================================

def slstm_with_state(xpre: torch.Tensor, r_mat: torch.Tensor
                     ) -> Tuple[torch.Tensor, State]:
    """sLSTM over a sequence from the zero state, and its final state.

    xpre: (B, S, 4, H, hd) pre-activations (x @ W + b); r_mat
    (H, hd, 4 hd).  Returns h (B, S, H, hd) in xpre's dtype and the final
    (c, n, h, m) in float32, both from one launch of the scan kernel."""
    b, _, _, h, hd = xpre.shape
    return slstm_ops.slstm_scan(xpre, r_mat,
                                *zero_state(b, h, hd, xpre.device))


def slstm_seq(xpre: torch.Tensor, r_mat: torch.Tensor) -> torch.Tensor:
    """sLSTM over a sequence from the zero state: h (B, S, H, hd) in
    xpre's dtype."""
    return slstm_with_state(xpre, r_mat)[0]


def _slstm_local_scan(xpre: torch.Tensor, r_mat: torch.Tensor,
                      state: State) -> Tuple[torch.Tensor, State]:
    """JAX's ``_slstm_local_scan`` (``recurrent.py:177``): the float32
    step loop, differentiable.  xpre: (B, S, 4, H, hd) float32; r_mat
    (H, hd, 4 hd), used in float32; state (c, n, h, m) (B, H, hd).
    Returns h (B, S, H, hd) float32 and the final state."""
    b, s, _, h, hd = xpre.shape
    r = r_mat.float()
    c, nrm, hprev, m = state
    out = []
    for t in range(s):
        rec = torch.einsum("bhd,hde->bhe", hprev, r).reshape(b, h, 4, hd)
        tot = xpre[:, t] + rec.transpose(1, 2)              # (B, 4, H, hd)
        z = torch.tanh(tot[:, 0])
        logi = tot[:, 1]
        logf = logsig(tot[:, 2])
        o = torch.sigmoid(tot[:, 3])
        m_new = torch.maximum(logf + m, logi)
        i_s = torch.exp(logi - m_new)
        f_s = torch.exp(logf + m - m_new)
        c = f_s * c + i_s * z
        nrm = f_s * nrm + i_s
        hprev = o * c / torch.clamp(nrm, min=1e-6)
        m = m_new
        out.append(hprev)
    return torch.stack(out, dim=1), (c, nrm, hprev, m)


def slstm_train(xpre: torch.Tensor, r_mat: torch.Tensor) -> torch.Tensor:
    """sLSTM over a sequence from the zero state on the training path
    (``slstm_seq``'s one-device branch, ``recurrent.py:208-230``): h
    (B, S, H, hd) in xpre's dtype, from the float32 step loop of
    ``_slstm_local_scan`` under autograd.  S steps of small ops: the
    serve path's scan kernel keeps R on chip, but has no backward."""
    b, _, _, h, hd = xpre.shape
    hs, _ = _slstm_local_scan(xpre.float(), r_mat,
                              zero_state(b, h, hd, xpre.device))
    return hs.to(xpre.dtype)


def slstm_decode_step(state: State, xpre_t: torch.Tensor,
                      r_mat: torch.Tensor) -> Tuple[State, torch.Tensor]:
    """xpre_t: (B, 4, H, hd); state (c, n, h, m) each (B, H, hd) float32.
    One step of the scan kernel; returns the new state and h (B, H, hd)
    in xpre_t's dtype."""
    hs, carry = slstm_ops.slstm_scan(xpre_t[:, None], r_mat, *state)
    return carry, hs[:, 0]


# ===========================================================================
# RG-LRU (Griffin recurrent block core)
# ===========================================================================

RGLRU_C = 8.0


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``softplus`` form, ``logaddexp(x, 0)``."""
    return -logsig(-x)


def causal_conv4(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution of width 4.  x: (B, S, dr); w: (4, dr);
    b: (dr,); tail: (B, 3, dr), the three inputs before x[:, 0]."""
    xp = torch.cat([tail, x], dim=1)
    out = b
    for j in range(4):
        out = out + xp[:, 3 - j:xp.shape[1] - j] * w[j]
    return out


def _rglru_gates(y: torch.Tensor, w_rg: torch.Tensor, b_rg: torch.Tensor,
                 w_ig: torch.Tensor, b_ig: torch.Tensor, lam: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, sqrt(1 - a²)·i·y) of the recurrence h = a·h + that, from the
    convolved input y (float32); the weights are used in float32, as JAX
    does with ``w.astype(f32)``."""
    r_g = torch.sigmoid(y @ w_rg.float() + b_rg.float())
    i_g = torch.sigmoid(y @ w_ig.float() + b_ig.float())
    a = torch.exp(-RGLRU_C * _softplus(lam.float()) * r_g)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i_g * y)
    return a, gated


def linear_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """h_t = a_t · h_{t-1} + x_t along dim 1 from h_{-1} = 0, in log2(S)
    doubling steps (Hillis–Steele): step d composes each position with
    the one d before it, ``(a, h) <- (a · a[-d], a · h[-d] + h)``.  Every
    product of a's stays in [0, 1], so nothing overflows (a running
    ``exp(cumsum(log a))`` would, within a few dozen positions)."""
    h = x
    d = 1
    while d < x.shape[1]:
        h = torch.cat([h[:, :d], a[:, d:] * h[:, :-d] + h[:, d:]], dim=1)
        if 2 * d < x.shape[1]:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return h


def rglru_seq(x_br: torch.Tensor, w_rg: torch.Tensor, b_rg: torch.Tensor,
              w_ig: torch.Tensor, b_ig: torch.Tensor, conv_w: torch.Tensor,
              conv_b: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Conv4 + RG-LRU over a sequence from the zero state (JAX's one-device
    ``local`` branch).  x_br: (B, S, dr), the recurrent branch's input.
    Returns h (B, S, dr) in x_br's dtype, computed in float32.  The scan
    associates in another order than ``lax.associative_scan``: the two
    agree to rounding."""
    b, _, dr = x_br.shape
    xf = x_br.float()
    tail = xf.new_zeros((b, 3, dr))
    y = causal_conv4(xf, conv_w.float(), conv_b.float(), tail)
    a, gated = _rglru_gates(y, w_rg, b_rg, w_ig, b_ig, lam)
    return linear_scan(a, gated).to(x_br.dtype)


def rglru_decode_step(state: Tuple[torch.Tensor, torch.Tensor],
                      x_t: torch.Tensor, w_rg: torch.Tensor,
                      b_rg: torch.Tensor, w_ig: torch.Tensor,
                      b_ig: torch.Tensor, conv_w: torch.Tensor,
                      conv_b: torch.Tensor, lam: torch.Tensor
                      ) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                                 torch.Tensor]:
    """One decode step.  state = (h (B, dr) float32, conv tail (B, 3, dr)
    float32); x_t: (B, dr).  Returns the new state and h (B, dr) in x_t's
    dtype."""
    h_prev, tail = state
    xf = x_t.float()
    y = causal_conv4(xf[:, None], conv_w.float(), conv_b.float(), tail)[:, 0]
    a, gated = _rglru_gates(y, w_rg, b_rg, w_ig, b_ig, lam)
    h = a * h_prev + gated
    new_tail = torch.cat([tail[:, 1:], xf[:, None]], dim=1)
    return (h, new_tail), h.to(x_t.dtype)
