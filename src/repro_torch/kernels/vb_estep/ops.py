"""Public wrappers of the sparse (CSR) VB E-step kernel (``csrc/vb_estep.cu``).

Source note.  ``vb_estep_csr`` replaces the Pallas kernel
``vb_estep_pallas`` (``src/repro/kernels/vb_estep/vb_estep.py:76``).
The TPU kernel runs the dense products, 4·D·K·V flops a iteration; a
doc-term x is mostly zeros (0.73% nonzero on the main path), and an
entry with x = 0 adds exactly 0 to γ and to sstats, so the kernel visits
only the nonzeros: 4·K flops per nonzero per iteration plus ~62 per
(document, topic) for the digamma update.  It is bound by those
operations; its inputs (CSR, eeβ, γ0) and outputs are a few MB.

Launch (a) gives each document one CTA, a thread per topic, which
gathers the document's rows of eeβ (from a (V, K) copy, so the gathers
are coalesced) into shared memory once and runs every iteration from
there.  The CTAs stay resident and take documents from a counter, so
the card holds as many documents in flight as fit and no tail wave is
left.  A document with more nonzeros than the row budget streams its
rows from L2 in chunks every iteration — in the kernel, not a fallback.
Launch (b) builds sstats a column per warp from the column view of the
same entries: no atomics, a fixed order, the same bits on every call.
Full fp32, no TF32; K is not padded.

``estep_plan`` sizes launch (a): the row budget R (every row of the
longest document, unless a CTA would then hold more than
``DOC_ROW_BYTES`` of rows) and the CTA's shared memory.  ``vb_estep``
keeps the dense signature and converts x per call; ``core.vb.vb_fit``
converts once per fit (``doc_term_csr``), or takes a CSR that the
device backend built from a window's tokens (``doc_term_csr_from_tokens``),
and calls ``vb_estep_csr``.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA
tensor goes to the kernel or raises.  ``launches`` counts kernel
launches: two per call (iterations, then sstats).  The (V, K) copy of
eeβ is a PyTorch transpose, not a launch of this module, but its time is
part of the call's.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import common
from repro_torch.kernels.vb_estep.csr import (
    DocTermCSR, doc_term_csr, doc_term_csr_from_tokens)
from repro_torch.kernels.vb_estep.ref import vb_estep_csr_ref

MAX_TOPICS = 256          # largest K the kernel takes (a thread per topic)
DOC_ROW_BYTES = 48 * 1024  # eeβ rows a CTA may hold: >= 4 documents an SM

launches = 0

__all__ = ["DocTermCSR", "doc_term_csr", "doc_term_csr_from_tokens",
           "estep_plan", "vb_estep", "vb_estep_csr"]


def _round4(n: int) -> int:
    return (n + 3) & ~3


def estep_plan(k: int, max_row: int) -> Tuple[int, int]:
    """(R, shared bytes) of a launch (a) CTA for K topics and documents
    of at most ``max_row`` nonzeros.

    R is the rows of eeβ a CTA keeps in shared memory, at a stride of an
    odd number of float4s: every row of the longest document, unless
    that exceeds ``DOC_ROW_BYTES``, when longer documents stream in
    chunks of R.  A CTA also holds eeθ and γ (K each), ψ of each
    thread's value (a thread per topic and a spare, at least 64) and the
    ratios (R); ``doc_floats`` in ``vb_estep.cu`` computes the same.
    """
    k4 = _round4(k)
    stride = k4 if (k4 // 4) % 2 else k4 + 4
    threads = max(64, (k + 32) // 32 * 32)
    r = max(1, min(max_row, DOC_ROW_BYTES // (4 * stride)))
    return r, 4 * (2 * k4 + _round4(threads) + _round4(r) + r * stride)


def cost(d: int, k: int, v: int, nnz: int, n_iters: int) -> common.Cost:
    """One call on a (D, V) CSR of ``nnz`` nonzeros: the CSR (indptr,
    indices, values, rows, col_ptr, perm), eeβ and γ0 read once, γ and
    the sstats written once; the operations this x needs: per iteration
    phinorm and the γ product at the nonzeros (4 · K flops each, products,
    plus the division) and the digamma/exp update of every γ entry (~62),
    then the final multiply by eeβ."""
    n_bytes = 4 * (4 * nnz + d + 1 + v + 1 + k * v + 2 * d * k + k * v)
    n_ops = (n_iters + 1) * (4 * k * nnz + nnz + 62 * d * k) + k * v
    return common.Cost(n_bytes, ((n_ops, common.PEAK_F32_FLOPS),),
                       (n_iters + 1) * 4 * k * nnz)


def vb_estep_csr(csr: DocTermCSR, exp_elog_beta: torch.Tensor,
                 gamma0: torch.Tensor, alpha: float, n_iters: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The E-step over the nonzeros of x (``doc_term_csr(x)``).

    exp_elog_beta (K, V), gamma0 (D, K), float32 on the CSR's device ->
    (gamma (D, K), sstats (K, V)).
    """
    d, v = csr.shape
    k = exp_elog_beta.shape[0]
    if exp_elog_beta.shape != (k, v) or gamma0.shape != (d, k):
        raise ValueError(
            f"shape mismatch: x {csr.shape}, exp_elog_beta "
            f"{tuple(exp_elog_beta.shape)}, gamma0 {tuple(gamma0.shape)}")
    dev = common.same_device(values=csr.values, exp_elog_beta=exp_elog_beta,
                             gamma0=gamma0)
    if dev.type == "cpu":
        return vb_estep_csr_ref(csr, exp_elog_beta, gamma0, alpha, n_iters)
    for name in ("indptr", "indices", "rows", "col_ptr", "perm"):
        common.require_cuda(name, getattr(csr, name), dev, torch.int32)
    for name, t in (("values", csr.values), ("exp_elog_beta", exp_elog_beta),
                    ("gamma0", gamma0)):
        common.require_cuda(name, t, dev)
    if not 1 <= k <= MAX_TOPICS or d < 1 or v < 1 or n_iters < 0:
        raise ValueError(f"vb_estep kernel takes 1 <= K <= {MAX_TOPICS}, "
                         f"D, V >= 1 and n_iters >= 0; got K={k}, D={d}, "
                         f"V={v}, n_iters={n_iters}")
    r, _ = estep_plan(k, csr.max_row)
    stream = common.stream_of(gamma0)
    eeb_t = exp_elog_beta.t().contiguous()       # (V, K): a row per term
    gamma = torch.empty((d, k), dtype=torch.float32, device=dev)
    ee_theta = torch.empty((d, k), dtype=torch.float32, device=dev)
    # the ratios, then one int of scratch: launch (a)'s document counter
    ratio = torch.empty((csr.nnz + 1,), dtype=torch.float32, device=dev)
    sstats = torch.empty((k, v), dtype=torch.float32, device=dev)
    common.launch(
        "vb_estep (iterations)", "mlego_vb_estep_csr_iters", dev,
        csr.indptr, csr.indices, csr.values, eeb_t, gamma0, gamma, ee_theta,
        ratio, ratio[csr.nnz:], d, k, r, float(alpha), int(n_iters),
        stream)
    common.launch(
        "vb_estep (sstats)", "mlego_vb_estep_csr_sstats", dev,
        csr.col_ptr, csr.perm, csr.rows, ratio, ee_theta, eeb_t, sstats, k,
        v, stream)
    common.count_launch(globals(), "launches", 2)
    return gamma, sstats


def vb_estep(x: torch.Tensor, exp_elog_beta: torch.Tensor,
             gamma0: torch.Tensor, alpha: float, n_iters: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused replacement for ``core.vb.vb_estep``'s inner loop.

    x (D, V), exp_elog_beta (K, V), gamma0 (D, K), all float32 on one
    device -> (gamma (D, K), sstats (K, V)).  Converts x to CSR on every
    call (one synchronisation); a caller with many calls on one x builds
    ``doc_term_csr(x)`` once and calls ``vb_estep_csr``.
    """
    d, v = x.shape
    k = exp_elog_beta.shape[0]
    if exp_elog_beta.shape != (k, v) or gamma0.shape != (d, k):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, exp_elog_beta "
            f"{tuple(exp_elog_beta.shape)}, gamma0 {tuple(gamma0.shape)}")
    dev = common.same_device(x=x, exp_elog_beta=exp_elog_beta, gamma0=gamma0)
    if dev.type == "cuda":
        common.require_cuda("x", x, dev)
    return vb_estep_csr(doc_term_csr(x), exp_elog_beta, gamma0, alpha,
                        n_iters)
