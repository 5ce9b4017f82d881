"""Public wrapper of the split-K decode attention kernel
(``csrc/decode_attention.cu``).

Source note.  ``decode_attention`` replaces the Pallas kernel
``decode_attention_pallas`` (``src/repro/kernels/decode_attention/
decode_attention.py:71``).  It is bound by bytes: one step reads every
live cache row once (~34 MB at the serve path's B = 4, pos = 2,100,
8 KV heads of 128 in bf16) for ~4 flops a byte, so what counts is how
many bytes each SM keeps in flight.  The caches stay in the model's
(B, S, KVH, hd) layout and are read through their strides (the Pallas
wrapper transposed the whole cache each call).  Grid (split, KV head,
batch): ``split_plan`` cuts the cache into chunks of whole 64-key tiles,
enough of them for about three waves of CTAs on the H100's 132 SMs
whatever B · KVH is, at most 64 (11 chunks of 192 at the served B = 4,
KVH = 8, S = 2,112: 352 CTAs, each with two tiles, 64 KB, in flight; 33
chunks of 64 for one sequence).  In bf16 each CTA copies its K and V
rows into shared memory in 16-byte ``cp.async`` pieces and runs both
products on the tensor cores (``mma.sync``, the G query heads padded to
16 rows, each warp on its own 16 keys of a tile, p rounded to bf16 before
P·V as in the prefill kernel); in f32 the CUDA-core kernel of the 1e-5
checks runs.  Nothing beyond ``pos`` or below the window is read; a
second launch combines the live splits' partial (acc, m, l) in split
order, so every run gives the same bits.  ``pos`` is an int32 scalar on
the device that the kernels read (the scalar prefetch's counterpart), so
a decode step needs no host value.

One shard of the split-K decode over a sequence-sharded cache
(``models/attention.py``) is called with ``pos - start`` and
``return_lse``: a shard past ``pos`` (pos < 0) or wholly below the window
has no live key and gives 0 with lse = -inf, and the combine writes the
output in float32 with each head's log-sum-exp (B, 1, H) float32, so the
shards are combined before one final cast.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA
tensor goes to the kernel of its dtype or raises (bf16 caches must be
16-byte aligned with strides that are multiples of 8 elements); a fake
tensor on any other device (a dry run's card) takes the shape-only route
(``common.shape_only``).  Each launch, real or shape-only, reports
:func:`cost` to an active ``launch.cost.OpCounter``, over the whole cache
when ``pos`` is a tensor (the count never reads the device).
``decode_attention_launches`` counts calls that launched the kernel
(each is two CUDA launches: partials and combine).
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.kernels import common
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.launch.cost import report_kernel

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernel's template instances
MAX_GROUP_DIMS = 2048                # G * hd the partial kernel holds
TILE = 64                            # keys per tile; a chunk is whole tiles
MAX_SPLITS = 64                      # the most partials the combine reads
WAVE_CTAS = 3 * 132                  # three waves on the H100's 132 SMs

decode_attention_launches = 0


def split_plan(s: int, n_pairs: int) -> Tuple[int, int]:
    """(n_split, chunk) for a cache of ``s`` positions read by ``n_pairs``
    = B · KVH CTAs a split: chunks of whole 64-key tiles, as long as keeps
    n_split · n_pairs at about ``WAVE_CTAS`` and n_split at most
    ``MAX_SPLITS``; split i covers [i·chunk, (i+1)·chunk)."""
    n_tiles = -(-s // TILE)
    want = min(MAX_SPLITS, -(-WAVE_CTAS // n_pairs))
    chunk = TILE * -(-n_tiles // want)
    return -(-s // chunk), chunk


def cost(b: int, s: int, h: int, kvh: int, hd: int, dtype: torch.dtype,
         pos: int, *, window: int = 0, return_lse: bool = False
         ) -> common.Cost:
    """One call's work at position ``pos``: the live cache rows of k and
    v (positions <= pos, and > pos - window) and q read once (q only when
    a key is live), the output (float32 with the lse) and the lse written
    once; 4 · hd flops per (head, live key)."""
    el = dtype.itemsize
    out_el = 4 if return_lse else el
    lo = max(0, pos - window + 1) if window else 0
    live = max(0, min(pos, s - 1) + 1 - lo)
    n_bytes = el * (2 * b * live * kvh * hd + (b * h * hd if live else 0)) \
        + out_el * b * h * hd + (4 * b * h if return_lse else 0)
    flops = 4 * hd * b * h * live
    peak = common.PEAK_BF16_TC_FLOPS if dtype == torch.bfloat16 \
        else common.PEAK_F32_FLOPS
    return common.Cost(n_bytes, ((flops, peak),), flops)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: Union[int, torch.Tensor],
                     *, window: int = 0, return_lse: bool = False):
    """q: (B, 1, H, hd); caches: (B, S, KVH, hd); ``pos`` the new token's
    position (on the card an int32 0-d tensor on the caches' device, or an
    int) -> (B, 1, H, hd) in q's dtype, computed in float32.  Attends to
    cache positions kpos <= pos (and kpos > pos - window).  With
    ``return_lse``: (out (B, 1, H, hd) float32, lse (B, 1, H) float32)."""
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"q must be (B, 1, H, hd) and the caches (B, S, "
                         f"KVH, hd); got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, _, h, hd = q.shape
    _, s, kvh, _ = k_cache.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != hd or h % kvh != 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}")
    dev = common.same_device(q=q, k_cache=k_cache, v_cache=v_cache)
    if dev.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, pos, window=window,
                                    return_lse=return_lse)
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        common.require_cuda(name, t, dev, DTYPES, contiguous=False)
    if not q.dtype == k_cache.dtype == v_cache.dtype:
        raise ValueError(f"q and the caches must share a dtype: {q.dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if q.dtype == torch.bfloat16:
        for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
            common.require_aligned16(name, t)
    g = h // kvh
    if hd not in HEAD_DIMS or g * hd > MAX_GROUP_DIMS:
        raise ValueError(f"decode_attention kernel takes hd in {HEAD_DIMS} "
                         f"and G * hd <= {MAX_GROUP_DIMS}; got hd={hd}, "
                         f"G={g}")
    if isinstance(pos, torch.Tensor):
        if pos.numel() != 1 or pos.dtype != torch.int32 \
                or pos.device != dev:
            raise ValueError(f"pos must be one int32 on {dev}, got "
                             f"{pos.dtype} {tuple(pos.shape)} on "
                             f"{pos.device}")
    out = torch.empty((b, 1, h, hd), dtype=torch.float32 if return_lse
                      else q.dtype, device=dev)
    lse = (torch.empty((b, 1, h), dtype=torch.float32, device=dev)
           if return_lse else None)
    at = s - 1 if isinstance(pos, torch.Tensor) else int(pos)
    report_kernel("decode_attention", dev, lambda: cost(
        b, s, h, kvh, hd, q.dtype, at, window=window, return_lse=return_lse))
    if common.shape_only(q):
        return (out, lse) if return_lse else out
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor(int(pos), dtype=torch.int32, device=dev)
    n_split, chunk = split_plan(s, b * kvh)
    part_acc = torch.empty((b, kvh, n_split, g * hd), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((b, kvh, n_split, 2 * g), dtype=torch.float32,
                          device=dev)
    common.launch(
        "decode_attention", "mlego_decode_attention", dev,
        q, k_cache, v_cache, pos, out, part_acc, part_ml,
        0 if q.dtype == torch.float32 else 1, b, s, h,
        kvh, hd, q.stride(0), q.stride(2), *k_cache.stride()[:3],
        *v_cache.stride()[:3], int(window), float(hd ** -0.5), n_split,
        chunk, lse, common.stream_of(q))
    common.count_launch(globals(), "decode_attention_launches")
    return (out, lse) if return_lse else out
