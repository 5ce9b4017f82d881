"""Attention of the dense stack, single-device forms.

The port of ``src/repro/models/attention.py``'s one-device paths:

  * ``flash_attention_local`` — prefill (``ring_attention`` on one
    device, ``attention.py:143``), through the flash kernel
    (``kernels/flash_attention``);
  * ``decode_attention`` — one new token: the cache write at ``pos``,
    then split-K flash over the cache through the decode kernel
    (``kernels/decode_attention``);
  * ``window_decode_attention`` — the rolling-window decode of the
    ``"local"`` layers, plain torch as in JAX;
  * ``cross_attention`` — the decoder's attention over the encoder's
    K/V, in prefill and in decode (``ring_attention`` with ``causal=False`` and S_q != S_kv in
    JAX, plain jnp there), plain torch here: the flash kernel takes one
    S for q and k.  Teaching it S_q != S_kv is later kernel work.

The ring over ranks of ``ring_attention`` waits for ROADMAP.md Queue 1
item 6.

Numerics: the scores are summed and scaled in float32 inside the kernels.
In bf16 both kernels run P·V on the tensor cores with the probabilities
rounded to bf16 first, as JAX's ``_flash_block`` casts p to the value
dtype (``attention.py:112``); the Pallas kernels keep p in float32, and
the two agree within the JAX tests' bf16 tolerance (2e-2).
In float32 the kernels keep p in float32 throughout and agree with both
to rounding.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops

NEG_INF = -1e30


def flash_attention_local(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KVH, hd), at positions 0..S-1 ->
    (B, S, H, hd)."""
    return flash_ops.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, pos: Union[int, torch.Tensor], *,
                     window: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a (B, S, KVH, hd) cache.

    Writes k_new/v_new (B, 1, KVH, hd) at ``pos`` IN PLACE — where JAX
    returns updated copies — and writes nothing when ``pos`` lies outside
    the cache (JAX's ``owned`` is false there), then attends to the
    positions kpos <= pos.  ``pos`` is an int or a 0-d int32 tensor on the
    caches' device; the write and the kernel read it there, with no host
    round trip.  Returns (out (B, 1, H, hd), k_cache, v_cache).
    """
    s = k_cache.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=k_cache.device)
    idx = pos.clamp(0, s - 1).reshape(1).long()
    owned = (pos >= 0) & (pos < s)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache.index_copy_(1, idx, torch.where(
            owned, new.to(cache.dtype), cache.index_select(1, idx)))
    out = decode_ops.decode_attention(q, k_cache, v_cache, pos,
                                      window=window)
    return out, k_cache, v_cache


def window_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, kpos: torch.Tensor,
                            k_new: torch.Tensor, v_new: torch.Tensor,
                            pos: Union[int, torch.Tensor], *, window: int
                            ) -> Tuple[torch.Tensor, ...]:
    """One-token decode against a rolling window cache (plain torch).

    q: (B, 1, H, hd); k/v_cache: (B, W, KVH, hd); kpos: (W,) int32 global
    positions of the cached entries (-1 = empty).  Writes the new KV at
    slot ``pos % W`` (in place) and attends to entries with
    pos - window < kpos <= pos.  Returns (out, k_cache, v_cache, kpos).
    """
    w = k_cache.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=k_cache.device)
    slot = (pos % w).reshape(1).long()
    k_cache.index_copy_(1, slot, k_new.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v_new.to(v_cache.dtype))
    kpos.index_copy_(0, slot, pos.reshape(1).to(kpos.dtype))
    b, _, h, hd = q.shape
    kvh = k_cache.shape[2]
    qg = q.reshape(b, 1, kvh, h // kvh, hd) * (hd ** -0.5)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), k_cache.float())
    valid = (kpos >= 0) & (kpos <= pos) & (kpos > pos - window)
    s = torch.where(valid[None, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgs,bskd->bqkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return (out.reshape(b, 1, h, hd).to(q.dtype), k_cache, v_cache, kpos)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Bidirectional attention of q (B, S_q, H, hd) over a memory k, v
    (B, S_kv, KVH, hd) -> (B, S_q, H, hd) in q's dtype (plain torch).
    JAX's one-device ``ring_attention(causal=False)`` step: q scaled in
    its own dtype, scores in float32, probabilities cast to v's dtype
    before P·V, the sum normalised in float32 at the end (JAX does it
    chunk by chunk with an online softmax: equal to rounding)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd) * (hd ** -0.5)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), k.float())
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bqkgs,bskd->bqkgd", p.to(v.dtype).float(),
                       v.float()) / l
    return out.reshape(b, sq, h, hd).to(q.dtype)
