"""Recurrent sequence mixers: mLSTM and sLSTM (xLSTM), RG-LRU (Griffin).

The port of ``src/repro/models/recurrent.py``, and of the two final-state
helpers of ``src/repro/models/model.py:832,848``.
The mLSTM and the RG-LRU are plain torch, as they are plain jnp in JAX,
and differentiate as they stand.  The sLSTM recurrence runs the scan
kernel (``kernels/slstm_scan``) in prefill and decode alike; on a CPU
tensor the kernel's wrapper takes its plain version.  The training path
(``Model.loss``) runs ``slstm_train``, JAX's float32 step loop under
autograd: the kernel's output carries no gradient.

Same numerical conventions as the JAX module (documented simplifications
of arXiv:2405.04517): the mLSTM input gate is log-sigmoid (bounded), the
sLSTM keeps exponential gating with the (c, n, m) stabiliser state.

On a grid (``env``; JAX's ``shard_map`` branches) the sequence is
sharded over the ``model`` axis and the batch over ``data``.  The linear
recurrences (mLSTM state, RG-LRU) cross the cells with
``_exclusive_ring_prefix``, a rank-order prefix over each cell's segment
summary (JAX composes the same summaries by Hillis–Steele doubling over
``ppermute``: the two associate differently and agree to rounding); the
RG-LRU's conv tail is the previous cell's last 3 rows (zeros on cell 0).
The sLSTM, whose gates read h, is a carry chain: cell 0 scans from the
zero state and cell r from cell r - 1's final state, one scan launch a
cell in rank order (JAX runs every rank's scan n times and keeps one;
the result is the same).  The ``*_with_state`` helpers return the last
cell's final state.  The public functions take and return whole tensors;
the ``*_cells`` forms take one tensor per cell.

Where JAX contracts three operands in one ``einsum``
(``"blhd,blhv,blh->bhdv"``), the port first folds the weights into k and
then contracts two: without ``opt_einsum``, torch would contract left to
right through a (B, S, H, hd, hd) float32 intermediate.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import MeshEnv
from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.kernels.slstm_scan.ref import State, logsig, zero_state
from repro_torch.launch.cost import kernel_interior

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
    (B, S, H, hd) and the final (C, n).  Each chunk is JAX's
    ``kernel_interior`` scope (``recurrent.py:75``)."""
    b, s, h, hd = q.shape
    L = chunk
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    C, nv = c0, n0
    outs = []
    for c in range(s // L):
        with kernel_interior():
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


def _exclusive_ring_prefix(summaries: sh.Cells, combine: Callable,
                           identity: Callable, env: MeshEnv,
                           axis: str = "model") -> sh.Cells:
    """Exclusive prefix over the ranks of ``axis`` of the cells' segment
    summaries (JAX's ``_exclusive_ring_prefix``, ``recurrent.py:31``):
    ``combine(earlier, later)`` composes two adjacent segments; each cell
    gets the composition of ranks 0..r-1 of its group, ``identity(like)``
    at rank 0.  Composed in rank order on the group's first device, then
    sent to each cell's."""
    out: List[Any] = [None] * len(summaries)
    for grp in sh._groups(env, (axis,)):
        dev0 = env.cells[grp[0]]
        acc = None
        for c in grp:
            dev = env.cells[c]
            out[c] = (identity(summaries[c]) if acc is None else
                      tuple(t.to(dev) for t in acc))
            mine = tuple(t.to(dev0) for t in summaries[c])
            acc = mine if acc is None else combine(acc, mine)
    return out


def _mlstm_summary(kf, vf, logi, logf):
    """A segment's (total decay (B, H), C delta (B, H, hd, hd), n delta
    (B, H, hd)) from its float32 k (scaled), v and log gates."""
    cum = torch.cumsum(logf, dim=1)
    wend = torch.exp(cum[:, -1:, :] - cum + logi)           # (B, S, H)
    kw = kf * wend[..., None]
    return (torch.exp(cum[:, -1]),
            torch.einsum("bshd,bshv->bhdv", kw, vf), kw.sum(dim=1))


def _mlstm_comb(e, l):
    """Two adjacent mLSTM segments, earlier e then later l."""
    de, ce, ne = e
    dl, cl, nl = l
    return (de * dl, dl[..., None, None] * ce + cl, dl[..., None] * ne + nl)


def _mlstm_ident(summary):
    d, c, n = summary
    return torch.ones_like(d), torch.zeros_like(c), torch.zeros_like(n)


def _mlstm_prep(q, k, v, i_raw, f_raw):
    hd = q.shape[-1]
    scale = hd ** -0.5
    return (q.float() * scale, k.float() * scale, v.float(),
            logsig(i_raw.float()), logsig(f_raw.float()))


def _mlstm_cells(qs, ks, vs, irs, frs, env: MeshEnv, chunk: int):
    """``mlstm_seq`` on one tensor per cell: each cell's segment summary,
    their exclusive prefix over ``model`` as the cell's initial (C, n),
    then the chunked scan.  Returns (h cells, the cells' summaries
    composed with their prefix: each cell's final state)."""
    prep = sh.cellwise(_mlstm_prep, qs, ks, vs, irs, frs)
    summ = sh.cellwise(lambda p: _mlstm_summary(*p[1:]), prep)
    pre = _exclusive_ring_prefix(summ, _mlstm_comb, _mlstm_ident, env)

    def scan(p, init, q):
        qf, kf, vf, logi, logf = p
        s = qf.shape[1]
        L = min(chunk, s)
        while s % L:
            L -= 1
        hs, _ = _mlstm_chunk_scan(qf, kf, vf, logi, logf, init[1],
                                  init[2], L)
        return hs.to(q.dtype)

    final = sh.cellwise(_mlstm_comb, pre, summ)
    return sh.cellwise(scan, prep, pre, qs), final


def mlstm_seq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              i_raw: torch.Tensor, f_raw: torch.Tensor, *,
              chunk: int = MLSTM_CHUNK,
              env: Optional[MeshEnv] = None) -> torch.Tensor:
    """mLSTM over a sequence from the zero state.

    q, k, v: (B, S, H, hd); i_raw, f_raw: (B, S, H).  Returns h
    (B, S, H, hd) in q's dtype, computed in float32 in chunks of
    L = the largest divisor of S that is at most ``chunk``.  With
    ``env``: S sharded over ``model`` (``_mlstm_cells``)."""
    if env is not None:
        b = q.shape[0]
        cells = [sh.shard(t, sh.seq_spec(env, b, t.dim()), env)
                 for t in (q, k, v, i_raw, f_raw)]
        hs, _ = _mlstm_cells(*cells, env, chunk)
        return sh.unshard(hs, sh.seq_spec(env, b, 4), env)
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
    C, nv = mlstm_decode_update(state, k, v, i_raw, f_raw)
    return (C, nv), mlstm_decode_readout(q, C, nv)


def mlstm_decode_update(state: Tuple[torch.Tensor, torch.Tensor],
                        k: torch.Tensor, v: torch.Tensor,
                        i_raw: torch.Tensor, f_raw: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decode step's new state (C, n) (``mlstm_decode_step``'s), by
    elementwise math alone."""
    C, nv = state
    hd = k.shape[-1]
    kf = k.float() * (hd ** -0.5)
    vf = v.float()
    i_g = torch.exp(logsig(i_raw.float()))[..., None]
    f_g = torch.exp(logsig(f_raw.float()))[..., None]
    C = f_g[..., None] * C + i_g[..., None] * (kf[..., :, None]
                                               * vf[..., None, :])
    nv = f_g * nv + i_g * kf
    return C, nv


def mlstm_decode_readout(q: torch.Tensor, C: torch.Tensor,
                         nv: torch.Tensor) -> torch.Tensor:
    """A decode step's h (B, H, hd) in q's dtype from the new state: the
    products q·n and q·C, head by head (any block of heads on its own)."""
    qf = q.float() * (q.shape[-1] ** -0.5)
    qn = torch.einsum("bhd,bhd->bh", qf, nv)
    h = torch.einsum("bhd,bhdv->bhv", qf, C) \
        / torch.clamp(qn.abs(), min=1.0)[..., None]
    return h.to(q.dtype)


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


def _slstm_chain(xs: sh.Cells, env: MeshEnv, scan: Callable
                 ) -> Tuple[sh.Cells, sh.Cells]:
    """The carry chain over ``model``: in each group, cell 0 runs
    ``scan(xpre, state, c)`` from the zero state and cell r from cell
    r - 1's final state (moved to its device), in rank order.  Returns (h
    cells, each cell's final state)."""
    hs: List[Any] = [None] * len(xs)
    finals: List[Any] = [None] * len(xs)
    for grp in sh._groups(env, ("model",)):
        carry = None
        done = {}
        for c in grp:
            x = xs[c]
            b, _, _, h, hd = x.shape
            st = (zero_state(b, h, hd, x.device) if carry is None else
                  tuple(t.to(x.device) for t in carry))
            key = (id(x), None if carry is None else id(carry[0]))
            if key not in done:
                done[key] = scan(x, st, c)
            hs[c], carry = done[key]
            finals[c] = carry
    return hs, finals


def slstm_seq(xpre: torch.Tensor, r_mat: torch.Tensor, *,
              env: Optional[MeshEnv] = None) -> torch.Tensor:
    """sLSTM over a sequence from the zero state: h (B, S, H, hd) in
    xpre's dtype.  With ``env``: S sharded over ``model``, the carry
    chain of scan kernel launches (``_slstm_chain``)."""
    if env is not None:
        spec = sh.seq_spec(env, xpre.shape[0], 5)
        hs, _ = _slstm_chain(
            sh.shard(xpre, spec, env), env,
            lambda x, st, c: slstm_ops.slstm_scan(x, r_mat.to(x.device),
                                                  *st))
        return sh.unshard(hs, sh.seq_spec(env, xpre.shape[0], 4), env)
    return slstm_with_state(xpre, r_mat)[0]


def _slstm_local_scan(xpre: torch.Tensor, r_mat: torch.Tensor,
                      state: State) -> Tuple[torch.Tensor, State]:
    """JAX's ``_slstm_local_scan`` (``recurrent.py:177``): the float32
    step loop, differentiable.  xpre: (B, S, 4, H, hd) float32; r_mat
    (H, hd, 4 hd), used in float32; state (c, n, h, m) (B, H, hd).
    Returns h (B, S, H, hd) float32 and the final state.  Each step is
    JAX's ``kernel_interior`` scope (``recurrent.py:184``)."""
    b, s, _, h, hd = xpre.shape
    r = r_mat.float()
    c, nrm, hprev, m = state
    out = []
    for t in range(s):
        with kernel_interior():
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


def slstm_train(xpre: torch.Tensor, r_mat: torch.Tensor, *,
                env: Optional[MeshEnv] = None) -> torch.Tensor:
    """sLSTM over a sequence from the zero state on the training path
    (``slstm_seq``'s one-device branch, ``recurrent.py:208-230``): h
    (B, S, H, hd) in xpre's dtype, from the float32 step loop of
    ``_slstm_local_scan`` under autograd.  S steps of small ops: the
    serve path's scan kernel keeps R on chip, but has no backward.  With
    ``env``: the same loop along the carry chain (``_slstm_chain``)."""
    if env is not None:
        spec = sh.seq_spec(env, xpre.shape[0], 5)
        hs, _ = _slstm_train_cells(sh.shard(xpre, spec, env),
                                   sh.replicate(r_mat, env), env)
        return sh.unshard(hs, sh.seq_spec(env, xpre.shape[0], 4), env)
    b, _, _, h, hd = xpre.shape
    hs, _ = _slstm_local_scan(xpre.float(), r_mat,
                              zero_state(b, h, hd, xpre.device))
    return hs.to(xpre.dtype)


def _slstm_train_cells(xs: sh.Cells, rs: sh.Cells, env: MeshEnv):
    """``slstm_train`` on one tensor per cell along the carry chain; rs:
    each cell's r_mat.  Returns (h cells in xpre's dtype, final states)."""
    def scan(x, st, c):
        hs, carry = _slstm_local_scan(x.float(), rs[c], st)
        return hs.to(x.dtype), carry

    return _slstm_chain(xs, env, scan)


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
    return _rglru_mix(y, y @ w_rg.float(), y @ w_ig.float(), b_rg, b_ig,
                      lam)


def _rglru_mix(y: torch.Tensor, rg: torch.Tensor, ig: torch.Tensor,
               b_rg: torch.Tensor, b_ig: torch.Tensor, lam: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_rglru_gates`` from the gates' products rg = y @ w_rg and
    ig = y @ w_ig (float32)."""
    r_g = torch.sigmoid(rg + b_rg.float())
    i_g = torch.sigmoid(ig + b_ig.float())
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


def _rglru_comb(e, l):
    """Two adjacent RG-LRU segments (decay product, end state)."""
    return e[0] * l[0], l[0] * e[1] + l[1]


def _rglru_cells(xs: sh.Cells, weights: List[sh.Cells], env: MeshEnv
                 ) -> sh.Cells:
    """``rglru_seq`` on one tensor per cell (``recurrent.py:278``): the
    conv tail is the previous ``model`` rank's last 3 rows (``ppermute``,
    zeros on rank 0), each cell's doubling scan from zero, then its
    exclusive prefix state h_in added as a_cum · h_in.  weights: the
    cells' (w_rg, b_rg, w_ig, b_ig, conv_w, conv_b, lam)."""
    xf = sh.cellwise(lambda x: x.float(), xs)
    tails = sh.ppermute(sh.cellwise(lambda x: x[:, -3:], xf), env, "model",
                        1, cyclic=False)

    def local(x, tail, w_rg, b_rg, w_ig, b_ig, conv_w, conv_b, lam):
        y = causal_conv4(x, conv_w.float(), conv_b.float(), tail)
        a, gated = _rglru_gates(y, w_rg, b_rg, w_ig, b_ig, lam)
        return torch.cumprod(a, dim=1), linear_scan(a, gated)

    scans = sh.cellwise(local, xf, tails, *weights)
    summ = sh.cellwise(lambda s: (s[0][:, -1], s[1][:, -1]), scans)
    pre = _exclusive_ring_prefix(
        summ, _rglru_comb,
        lambda s: (torch.ones_like(s[0]), torch.zeros_like(s[1])), env)
    return sh.cellwise(lambda s, p, x: (s[1] + s[0] * p[1][:, None]).to(
        x.dtype), scans, pre, xs)


def rglru_seq(x_br: torch.Tensor, w_rg: torch.Tensor, b_rg: torch.Tensor,
              w_ig: torch.Tensor, b_ig: torch.Tensor, conv_w: torch.Tensor,
              conv_b: torch.Tensor, lam: torch.Tensor, *,
              env: Optional[MeshEnv] = None) -> torch.Tensor:
    """Conv4 + RG-LRU over a sequence from the zero state (JAX's one-device
    ``local`` branch).  x_br: (B, S, dr), the recurrent branch's input.
    Returns h (B, S, dr) in x_br's dtype, computed in float32.  The scan
    associates in another order than ``lax.associative_scan``: the two
    agree to rounding.  With ``env``: S sharded over ``model``
    (``_rglru_cells``)."""
    if env is not None:
        spec = sh.seq_spec(env, x_br.shape[0], 3)
        ws = [sh.replicate(w, env) for w in (w_rg, b_rg, w_ig, b_ig, conv_w,
                                             conv_b, lam)]
        return sh.unshard(_rglru_cells(sh.shard(x_br, spec, env), ws, env),
                          spec, env)
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
    y = rglru_decode_conv(state[1], x_t, conv_w, conv_b)
    return rglru_decode_gates(state, x_t, y, y @ w_rg.float(),
                              y @ w_ig.float(), b_rg, b_ig, lam)


def rglru_decode_conv(tail: torch.Tensor, x_t: torch.Tensor,
                      conv_w: torch.Tensor, conv_b: torch.Tensor
                      ) -> torch.Tensor:
    """A decode step's convolved input y (B, dr) float32, from the conv
    tail and x_t (B, dr)."""
    return causal_conv4(x_t.float()[:, None], conv_w.float(),
                        conv_b.float(), tail)[:, 0]


def rglru_decode_gates(state: Tuple[torch.Tensor, torch.Tensor],
                       x_t: torch.Tensor, y: torch.Tensor, rg: torch.Tensor,
                       ig: torch.Tensor, b_rg: torch.Tensor,
                       b_ig: torch.Tensor, lam: torch.Tensor
                       ) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                                  torch.Tensor]:
    """The rest of ``rglru_decode_step`` from y and its gate products
    rg = y @ w_rg, ig = y @ w_ig (float32): the new state and h."""
    h_prev, tail = state
    a, gated = _rglru_mix(y, rg, ig, b_rg, b_ig, lam)
    h = a * h_prev + gated
    new_tail = torch.cat([tail[:, 1:], x_t.float()[:, None]], dim=1)
    return (h, new_tail), h.to(x_t.dtype)
