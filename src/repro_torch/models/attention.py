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
    S for q and k.  Teaching it S_q != S_kv is later kernel work;
  * ``ring_attention`` — the training path (``Model.loss``): JAX's
    one-device ``ring_attention`` (``attention.py:161``), the jnp flash
    math of ``flash_attention_local``, ``_flash_update`` and
    ``_flash_block`` (``attention.py:55-160``) in plain torch under
    autograd, each KV chunk recomputed in the backward.  It reaches no
    kernel: the JAX package has no backward kernel to port, and the flash
    kernel's output carries no gradient (its wrapper refuses tensors that
    require grad).

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


# ---------------------------------------------------------------------------
# the training path: JAX's jnp flash math under autograd
# ---------------------------------------------------------------------------

KV_CHUNK = 512


class _MatmulF32(torch.autograd.Function):
    """``torch.bmm`` of two bfloat16 batches, summed and returned in
    float32: JAX's ``einsum(..., preferred_element_type=float32)``, whose
    result is never rounded to bfloat16.  On the card the product runs on
    the tensor cores (``torch.bmm(..., out_dtype=torch.float32)``); on the
    CPU, which has no such product, the operands are widened first (each
    bf16 product is exact in float32, so only the order of the sums
    differs).  The backward rounds the float32 cotangent to bfloat16 and
    runs both products on the tensor cores, as FlashAttention's backward
    does; JAX forms them from the float32 cotangent and rounds the
    results, so the two part by bf16 rounding of the cotangent."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.bmm(a, b, out_dtype=torch.float32)
        return torch.bmm(a.float(), b.float())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return torch.bmm(g, b.transpose(1, 2)), torch.bmm(a.transpose(1, 2), g)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, m, k) @ (N, k, n) -> (N, m, n) float32, summed in float32."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    return _MatmulF32.apply(a, b)


def _pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (``attention.py:46``)."""
    if n <= target:
        return n
    for c in range(target, 0, -1):
        if n % c == 0:
            return c
    return n


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    """(Sq, Sk) bool validity mask from global positions."""
    d = qpos[:, None] - kpos[None, :]
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= d >= 0
    if window > 0:
        m &= d < window
    return m


def _flash_block(acc: torch.Tensor, l: torch.Tensor, m: torch.Tensor,
                 q: torch.Tensor, k_c: torch.Tensor, v_c: torch.Tensor,
                 masked: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Online-softmax update of (acc, l, m) with one KV chunk
    (``attention.py:96``).  Head-major rows: q (N, R, hd), already scaled,
    R = Sq·G rows ordered (query, head of the group); k_c, v_c
    (N, C, hd); masked (R, C), true where a key is not attended; acc
    (N, R, hd), l and m (N, R) float32."""
    s = _bmm_f32(q, k_c.transpose(1, 2))                      # (N, R, C)
    s = s.masked_fill(masked, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None]).masked_fill(masked, 0.0)
    coef = torch.exp(m - m_new)
    l = l * coef + p.sum(-1)
    pv = _bmm_f32(p.to(v_c.dtype), v_c)
    return acc * coef[..., None] + pv, l, m_new


class _FlashChunk(torch.autograd.Function):
    """``_flash_block`` whose backward recomputes the chunk's scores from
    its inputs (JAX's ``jax.checkpoint(body)``).  Not
    ``torch.utils.checkpoint``: that keeps each call's inputs alive
    through its recompute closure, so inside a layer that is itself
    rematerialised (``Model._run_stack``) every chunk's float32 (acc, l,
    m) of every layer would stay resident until the backward (15 GB at
    qwen3-1.7b's 28 layers and 2 × 4,096 tokens).  Here the inputs are
    saved through ``save_for_backward``, which the outer remat drops and
    recomputes like any other saved tensor."""

    @staticmethod
    def forward(ctx, acc, l, m, q, k_c, v_c, masked):
        ctx.save_for_backward(acc, l, m, q, k_c, v_c, masked)
        return _flash_block(acc, l, m, q, k_c, v_c, masked)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        ins = [t.detach().requires_grad_(need) for t, need in
               zip(saved[:6], ctx.needs_input_grad[:6])]
        with torch.enable_grad():
            outs = _flash_block(*ins, saved[6])
        wanted = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(outs, wanted, grads))
        return (*[next(got) if t.requires_grad else None for t in ins],
                None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention of the training path: JAX's ``ring_attention`` on one
    device.  q: (B, Sq, H, hd); k, v: (B, Sk, KVH, hd), Sk may differ
    from Sq (cross attention, ``causal=False``); query i and key j sit
    at positions i and j.  Returns (B, Sq, H, hd) in q's dtype.

    The math is JAX's, step for step: q scaled by hd^-1/2 in its own
    dtype; the keys in chunks of the largest divisor of Sk that is at most
    ``KV_CHUNK`` (512, as ``_pick_chunk`` picks it); the scores and the
    running max and sum in float32; masked scores set to -1e30 and their
    probabilities to 0; P cast to v's dtype before P·V, accumulated in
    float32; every chunk computed, masked or not.  Each chunk is
    rematerialised (``_FlashChunk``, JAX's ``jax.checkpoint(body)``,
    ``attention.py:91``): the backward keeps only each chunk's (acc, l,
    m) and recomputes its scores.  In bfloat16 both products run on
    the tensor cores with float32 sums and a float32 result
    (``_MatmulF32``); widening q and k to float32 instead would move the
    products onto the CUDA cores (67 against 989 TFLOP/s).  The cost is
    every chunk's full (Sq·G, chunk) score block: causal masking halves
    the useful work, and none of it is skipped, as in JAX."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    dev = q.device
    qh = (q * (hd ** -0.5)).reshape(b, sq, kvh, g, hd).permute(
        0, 2, 1, 3, 4).reshape(b * kvh, sq * g, hd)
    kh, vh = (t.permute(0, 2, 1, 3).reshape(b * kvh, sk, hd)
              for t in (k, v))
    qpos = torch.arange(sq, device=dev)
    kpos = torch.arange(sk, device=dev)
    acc = torch.zeros((b * kvh, sq * g, hd), dtype=torch.float32, device=dev)
    l = torch.zeros((b * kvh, sq * g), dtype=torch.float32, device=dev)
    m = torch.full((b * kvh, sq * g), NEG_INF, dtype=torch.float32,
                   device=dev)
    chunk = _pick_chunk(sk, KV_CHUNK)
    for c in range(sk // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        masked = ~_mask(qpos, kpos[sl], causal, window)
        masked = masked[:, None, :].expand(sq, g, chunk).reshape(sq * g,
                                                                 chunk)
        acc, l, m = _FlashChunk.apply(acc, l, m, qh, kh[:, sl], vh[:, sl],
                                      masked)
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(b, kvh, sq, g, hd).permute(0, 2, 1, 3, 4).reshape(
        b, sq, h, hd).to(q.dtype)
