"""Public wrapper of the prefill attention kernel
(``csrc/flash_attention.cu``).

Source note.  ``flash_attention`` replaces the Pallas kernel
``flash_attention_pallas`` (``src/repro/kernels/flash_attention/
flash_attention.py:85``).  It is bound by operations: at the serve
path's shape (B = 4, S = 2,048, 16 query and 8 KV heads of 128, causal)
a call does ~69 GFLOP against ~8 MB of inputs and output.  The kernel
gives one CTA to each (q tile, KV head, batch) and holds the G query
heads of a KV head as extra rows, so each K/V tile is read once per
group; the TPU's sequential KV grid axis becomes a loop inside the CTA
with the online softmax in f32 registers; tiles above the causal
diagonal and below the window band are skipped, the heaviest q tiles
first.  It reads q, k and v through their strides in the model's
(B, S, heads, hd) layout, so the Pallas wrapper's transpose copies are
gone.  One dispatch by ``q.dtype`` picks the instance:

  * bfloat16 — both products on the tensor cores (``mma.sync`` bf16 →
    f32, FlashAttention-2 shape: two 16-row m-tiles a warp for hd <= 128,
    K/V tiles in a 16-byte ``cp.async`` ring, P rounded to bf16 in
    registers as JAX's ``_flash_block`` does, the heaviest causal tiles
    of every head dispatched first).  Its 16-byte copies need q, k and v 16-byte
    aligned with strides that are multiples of 8 elements; any other
    view raises ``ValueError``;
  * float32 — CUDA-core FMAs in full fp32 (TF32 would break the 1e-5
    tolerance of the JAX kernel tests).

One step of the sequence-parallel ring (``models/attention.py``) calls it
with ``q_offset`` (the queries sit at positions q_offset + i against keys
at j: the masks and the visible KV tiles move with it) and
``return_lse``: the output then comes in float32 with each row's
log-sum-exp (B, S, H) float32, -inf for a row that saw no key (whose
output is 0), so the steps are combined before one final cast.  With
q_offset = 0 and no lse the launch is the one it always was.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA
tensor goes to one of the two kernels or raises; a fake tensor on any
other device (a dry run's card) takes the shape-only route
(``common.shape_only``).  Each launch, real or shape-only, reports
:func:`cost` to an active ``launch.cost.OpCounter``.
``flash_attention_launches`` counts kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.launch.cost import report_kernel

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernel's template instances
MAX_GROUP = 64                       # query heads per KV head in one CTA

flash_attention_launches = 0


def pairs(s: int, causal: bool, window: int, q_offset: int = 0) -> int:
    """The (query, key) pairs one (batch, head) attends: query i at
    position q_offset + i, keys j in [0, s), under the kernel's masks."""
    p = q_offset + np.arange(s, dtype=np.int64)
    hi = np.minimum(s - 1, p) if causal else np.full(s, s - 1)
    lo = np.maximum(0, p - window + 1) if window else 0
    return int(np.maximum(0, hi - lo + 1).sum())


def cost(b: int, s: int, h: int, kvh: int, hd: int, dtype: torch.dtype, *,
         causal: bool = True, window: int = 0, q_offset: int = 0,
         return_lse: bool = False) -> common.Cost:
    """One call's work: q, k and v read once, the output (float32 with
    the lse) and the lse written once; 4 · hd flops a (query, key) pair
    the masks keep, per head (QK and PV, on the tensor cores in bf16, at
    the fp32 peak in float32)."""
    el = dtype.itemsize
    out_el = 4 if return_lse else el
    n_bytes = el * (b * s * h * hd + 2 * b * s * kvh * hd) \
        + out_el * b * s * h * hd + (4 * b * s * h if return_lse else 0)
    flops = 4 * hd * b * h * pairs(s, causal, window, q_offset)
    peak = common.PEAK_BF16_TC_FLOPS if dtype == torch.bfloat16 \
        else common.PEAK_F32_FLOPS
    return common.Cost(n_bytes, ((flops, peak),), flops)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    return_lse: bool = False):
    """q: (B, S, H, hd); k, v: (B, S, KVH, hd) -> (B, S, H, hd) in q's
    dtype (float32 or bfloat16), accumulated in float32 (in bfloat16 the
    probabilities are rounded to bfloat16 before P·V).  Query i, at
    position q_offset + i, attends to key j when j <= q_offset + i
    (``causal``) and q_offset + i - j < ``window`` (``window`` > 0).
    With ``return_lse``: (out (B, S, H, hd) float32, lse (B, S, H)
    float32)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, S, H, hd) and k, v (B, S, KVH, hd);"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != hd \
            or h % kvh != 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    dev = common.same_device(q=q, k=k, v=v)
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, return_lse=return_lse)
    for name, t in (("q", q), ("k", k), ("v", v)):
        common.require_cuda(name, t, dev, DTYPES, contiguous=False)
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v must share a dtype: {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            common.require_aligned16(name, t)
    if hd not in HEAD_DIMS or h // kvh > MAX_GROUP:
        raise ValueError(f"flash_attention kernel takes hd in {HEAD_DIMS} "
                         f"and at most {MAX_GROUP} query heads per KV head;"
                         f" got hd={hd}, H={h}, KVH={kvh}")
    out = torch.empty((b, s, h, hd), dtype=torch.float32 if return_lse
                      else q.dtype, device=dev)
    lse = (torch.empty((b, s, h), dtype=torch.float32, device=dev)
           if return_lse else None)
    report_kernel("flash_attention", dev, lambda: cost(
        b, s, h, kvh, hd, q.dtype, causal=causal, window=window,
        q_offset=q_offset, return_lse=return_lse))
    if common.shape_only(q):
        return (out, lse) if return_lse else out
    common.launch(
        "flash_attention", "mlego_flash_attention", dev,
        q, k, v, out, 0 if q.dtype == torch.float32 else 1, b, s, h, kvh,
        hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(bool(causal)), int(window), float(hd ** -0.5), q_offset, lse,
        common.stream_of(q))
    common.count_launch(globals(), "flash_attention_launches")
    return (out, lse) if return_lse else out
