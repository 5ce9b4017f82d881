"""Public wrapper of the split-K decode attention kernel
(``csrc/decode_attention.cu``).

Source note.  ``decode_attention`` replaces the Pallas kernel
``decode_attention_pallas`` (``src/repro/kernels/decode_attention/
decode_attention.py:71``).  It is bound by bytes: one step reads every
live cache row once (~34 MB at the serve path's B = 4, pos = 2,100,
8 KV heads of 128 in bf16) for ~4 flops a byte.  The caches stay in the
model's (B, S, KVH, hd) layout and are read through their strides (the
Pallas wrapper transposed the whole cache each call).  Grid (split, KV
head, batch): each CTA walks its share of the positions for the G query
heads of its KV head, reading nothing beyond ``pos`` or below the
window, and writes a partial (acc, m, l) in f32; a second launch
combines the splits in a fixed order, so every run gives the same bits.
``pos`` is an int32 scalar on the device that the kernel reads (the
scalar prefetch's counterpart), so a decode step needs no host value.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA
tensor goes to the kernel or raises.  ``decode_attention_launches``
counts calls that launched the kernel (each is two CUDA launches:
partials and combine).
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.kernels import common
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernel's template instances
MAX_GROUP_DIMS = 2048                # G * hd the partial kernel holds
TILE = 64                            # keys per tile inside a split
SPLIT = 128                          # positions per split (two tiles)
MAX_SPLITS = 64

decode_attention_launches = 0


def split_plan(s: int) -> Tuple[int, int]:
    """(n_split, chunk) for a cache of ``s`` positions: chunks of 128
    positions, at most 64 of them (longer caches get longer chunks)."""
    chunk = SPLIT
    n_split = -(-s // chunk)
    if n_split > MAX_SPLITS:
        n_tiles = -(-s // TILE)
        chunk = TILE * -(-n_tiles // MAX_SPLITS)
        n_split = -(-s // chunk)
    return n_split, chunk


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: Union[int, torch.Tensor],
                     *, window: int = 0) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, S, KVH, hd); ``pos`` the new token's
    position (on the card an int32 0-d tensor on the caches' device, or an
    int) -> (B, 1, H, hd) in q's dtype, computed in float32.  Attends to
    cache positions kpos <= pos (and kpos > pos - window)."""
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
        return decode_attention_ref(q, k_cache, v_cache, pos, window=window)
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        common.require_cuda(name, t, dev, DTYPES, contiguous=False)
    if not q.dtype == k_cache.dtype == v_cache.dtype:
        raise ValueError(f"q and the caches must share a dtype: {q.dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype}")
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
    else:
        pos = torch.tensor(int(pos), dtype=torch.int32, device=dev)
    n_split, chunk = split_plan(s)
    out = torch.empty((b, 1, h, hd), dtype=q.dtype, device=dev)
    part_acc = torch.empty((b, kvh, n_split, g * hd), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((b, kvh, n_split, 2 * g), dtype=torch.float32,
                          device=dev)
    lib = common.load_library()
    status = lib.mlego_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        pos.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), 0 if q.dtype == torch.float32 else 1, b, s, h,
        kvh, hd, q.stride(0), q.stride(2), *k_cache.stride()[:3],
        *v_cache.stride()[:3], int(window), float(hd ** -0.5), n_split,
        chunk, common.stream_of(q))
    common.check_launch(status, "decode_attention")
    common.count_launch(globals(), "decode_attention_launches")
    return out
