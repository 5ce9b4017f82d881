"""Attention of the dense stack, on one device and on a grid.

The port of ``src/repro/models/attention.py``.  On one device (``env``
None):

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

On a grid (``env``, a ``distributed.sharding.MeshEnv``; JAX's
``shard_map`` branches), activations are sequence-sharded over the
``model`` axis and batch-sharded over ``data``:

  * ``ring_attention`` — each cell's queries against the K/V blocks that
    rotate around the ``model`` ring (``ppermute``), JAX's step order:
    at step s cell r holds block (r - s) mod n.  Blocks above the causal
    diagonal are skipped, and a window stops the ring after
    min(n, ceil(window / S_loc) + 1) steps (``attention.py:171-174``); a
    skipped block is one JAX masks whole, which leaves its online softmax
    unchanged bit for bit.  In serving (no grad) each step is one flash
    kernel launch with ``q_offset = (r - blk) · S_loc`` and the row
    log-sum-exp, the steps' float32 outputs combined by their lse in step
    order before one cast.  In training the same ring runs JAX's jnp
    flash math (``_flash_update``) under autograd with global positions;
  * ``cross_attention`` — the bidirectional ring over a sequence-sharded
    memory, S_q != S_kv: plain torch blocks combined by their lse (the
    flash kernel takes one S for q and k);
  * ``decode_attention`` — the cache sequence-sharded (``cache_specs``):
    the cell that owns ``pos`` writes the new K/V, each cell runs the
    decode kernel on its shard with ``pos - start`` (a shard past ``pos``
    has no live key: 0 and lse = -inf), and the shards' float32 outputs
    are combined by their lse in rank order (JAX's ``pmax``/``psum``);
  * ``_window_decode_cells`` — the rolling window's slots cut over
    ``model`` (``cache_specs``): each cell attends over its slots in plain
    torch and the outputs are combined by their lse in rank order, as
    JAX's XLA runs the jnp window attention on the same shards.

The public functions take and return whole tensors, as JAX's do; the
``*_cells`` forms take one tensor per cell and are what ``Model`` runs.

Numerics: the scores are summed and scaled in float32 inside the kernels.
In bf16 both kernels run P·V on the tensor cores with the probabilities
rounded to bf16 first, as JAX's ``_flash_block`` casts p to the value
dtype (``attention.py:112``); the Pallas kernels keep p in float32, and
the two agree within the JAX tests' bf16 tolerance (2e-2).
In float32 the kernels keep p in float32 throughout and agree with both
to rounding.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple, Union

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import MeshEnv
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.cost import kernel_interior

NEG_INF = -1e30


def flash_attention_local(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KVH, hd), at positions 0..S-1 ->
    (B, S, H, hd)."""
    return flash_ops.flash_attention(q, k, v, causal=causal, window=window)


def _write_at(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor
              ) -> None:
    """``new`` (B, 1, ...) into ``cache`` (B, S, ...) at position ``pos``
    (a 0-d int32 tensor on the cache's device) in place, and nothing when
    ``pos`` lies outside the cache (JAX's ``owned``)."""
    s = cache.shape[1]
    idx = pos.clamp(0, s - 1).reshape(1).long()
    owned = (pos >= 0) & (pos < s)
    cache.index_copy_(1, idx, torch.where(
        owned, new.to(cache.dtype), cache.index_select(1, idx)))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, pos: Union[int, torch.Tensor], *,
                     window: int = 0, env: Optional[MeshEnv] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a (B, S, KVH, hd) cache.

    Writes k_new/v_new (B, 1, KVH, hd) at ``pos`` IN PLACE — where JAX
    returns updated copies — and writes nothing when ``pos`` lies outside
    the cache (JAX's ``owned`` is false there), then attends to the
    positions kpos <= pos.  ``pos`` is an int or a 0-d int32 tensor on the
    caches' device; the write and the kernel read it there, with no host
    round trip.  Returns (out (B, 1, H, hd), k_cache, v_cache).

    With ``env``: the caches' S is sharded over ``model`` and the batch
    over ``data`` (``_decode_cells``); the returned caches are the
    written shards joined whole (the inputs themselves, written in place,
    when the grid repeats their device).
    """
    if env is not None:
        b = q.shape[0]
        rep_spec, seq_spec = sh.seq_spec(env, b, 4, False), sh.seq_spec(
            env, b, 4)
        caches = [sh.shard(t, seq_spec, env) for t in (k_cache, v_cache)]
        out = _decode_cells(
            sh.shard(q, rep_spec, env), *caches,
            sh.shard(k_new, rep_spec, env), sh.shard(v_new, rep_spec, env),
            pos, env, window=window)
        return (sh.unshard(out, rep_spec, env),
                *(sh.unshard(c, seq_spec, env) for c in caches))
    pos = torch.as_tensor(pos, dtype=torch.int32, device=k_cache.device)
    _write_at(k_cache, k_new, pos)
    _write_at(v_cache, v_new, pos)
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
    # one block normalised over the whole window is the softmax
    out = _window_partial(q, k_cache, v_cache, kpos, pos, window)[0]
    return out.to(q.dtype), k_cache, v_cache, kpos


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    env: Optional[MeshEnv] = None) -> torch.Tensor:
    """Bidirectional attention of q (B, S_q, H, hd) over a memory k, v
    (B, S_kv, KVH, hd) -> (B, S_q, H, hd) in q's dtype (plain torch).
    JAX's one-device ``ring_attention(causal=False)`` step: q scaled in
    its own dtype, scores in float32, probabilities cast to v's dtype
    before P·V, the sum normalised in float32 at the end (JAX does it
    chunk by chunk with an online softmax: equal to rounding).  With
    ``env``: the bidirectional ring over the memory (``_ring_cells``), q
    and the memory sequence-sharded over ``model``."""
    if env is not None:
        spec = sh.seq_spec(env, q.shape[0], 4)
        out = _ring_cells(*(sh.shard(t, spec, env) for t in (q, k, v)),
                          env, causal=False, window=0)
        return sh.unshard(out, spec, env)
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd) * (hd ** -0.5)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), k.float())
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bqkgs,bskd->bqkgd", p.to(v.dtype).float(),
                       v.float()) / l
    return out.reshape(b, sq, h, hd).to(q.dtype)


def cross_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Attention of a decode step's q (B, 1, H, hd) over the encoder's
    k, v (B, S_kv, KVH, hd) -> (B, 1, H, hd) in q's dtype (plain torch),
    in the order of JAX's decode step (``cross_step``, ``model.py:751``):
    float32 scores scaled by hd^-0.5, a float32 softmax, the normalised
    probabilities cast to v's dtype, then P·V.  ``cross_attention``
    scales q in its own dtype and normalises after P·V: in bf16 the two
    part by rounding."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), k.float())
    p = torch.softmax(s * (hd ** -0.5), dim=-1).to(v.dtype)
    out = torch.einsum("bqkgs,bskd->bqkgd", p.float(), v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# the training path: JAX's jnp flash math under autograd
# ---------------------------------------------------------------------------

KV_CHUNK = 512


class _MatmulF32(torch.autograd.Function):
    """``torch.bmm`` of two bfloat16 batches, summed and returned in
    float32: JAX's ``einsum(..., preferred_element_type=float32)``, whose
    result is never rounded to bfloat16.  On the card (and a dry run's
    fake card) the product runs on the tensor cores (``torch.bmm(...,
    out_dtype=torch.float32)``); on the CPU, which has no such product,
    the operands are widened first (each
    bf16 product is exact in float32, so only the order of the sums
    differs).  The backward rounds the float32 cotangent to bfloat16 and
    runs both products on the tensor cores, as FlashAttention's backward
    does; JAX forms them from the float32 cotangent and rounds the
    results, so the two part by bf16 rounding of the cotangent."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        if a.device.type != "cpu":
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
    recomputes like any other saved tensor.  Both passes are JAX's
    ``kernel_interior`` scope (``attention.py:98``): a fused kernel keeps
    their scores on chip."""

    @staticmethod
    def forward(ctx, acc, l, m, q, k_c, v_c, masked):
        ctx.save_for_backward(acc, l, m, q, k_c, v_c, masked)
        with kernel_interior():
            return _flash_block(acc, l, m, q, k_c, v_c, masked)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        ins = [t.detach().requires_grad_(need) for t, need in
               zip(saved[:6], ctx.needs_input_grad[:6])]
        with torch.enable_grad(), kernel_interior():
            outs = _flash_block(*ins, saved[6])
            wanted = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(outs, wanted, grads))
        return (*[next(got) if t.requires_grad else None for t in ins],
                None)


def _heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q scaled by hd^-1/2 in its own dtype, as head-major rows (B·KVH,
    Sq·G, hd) ordered (query, head of the group); k, v as (B·KVH, Sk,
    hd)."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qh = (q * (hd ** -0.5)).reshape(b, sq, kvh, g, hd).permute(
        0, 2, 1, 3, 4).reshape(b * kvh, sq * g, hd)
    kh, vh = (t.permute(0, 2, 1, 3).reshape(b * kvh, sk, hd)
              for t in (k, v))
    return qh, kh, vh


def _init_state(n: int, rows: int, hd: int, dev: torch.device):
    """(acc, l, m) of the online softmax, float32."""
    return (torch.zeros((n, rows, hd), dtype=torch.float32, device=dev),
            torch.zeros((n, rows), dtype=torch.float32, device=dev),
            torch.full((n, rows), NEG_INF, dtype=torch.float32, device=dev))


def _flash_update(state, qh: torch.Tensor, kh: torch.Tensor,
                  vh: torch.Tensor, qpos: torch.Tensor, kpos: torch.Tensor,
                  causal: bool, window: int, g: int):
    """JAX's ``_flash_update`` (``attention.py:67``) on head-major rows:
    the keys in chunks of the largest divisor of Sk that is at most
    ``KV_CHUNK``, each chunk rematerialised (``_FlashChunk``); every chunk
    computed, masked or not.  qpos (Sq,), kpos (Sk,) global positions."""
    acc, l, m = state
    sq, sk = qpos.shape[0], kpos.shape[0]
    chunk = _pick_chunk(sk, KV_CHUNK)
    for c in range(sk // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        masked = ~_mask(qpos, kpos[sl], causal, window)
        masked = masked[:, None, :].expand(sq, g, chunk).reshape(sq * g,
                                                                 chunk)
        acc, l, m = _FlashChunk.apply(acc, l, m, qh, kh[:, sl], vh[:, sl],
                                      masked)
    return acc, l, m


def _finish(state, b: int, sq: int, h: int, hd: int,
            dtype: torch.dtype) -> torch.Tensor:
    acc, l, _ = state
    kvh = acc.shape[0] // b
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(b, kvh, sq, h // kvh, hd).permute(
        0, 2, 1, 3, 4).reshape(b, sq, h, hd).to(dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   env: Optional[MeshEnv] = None) -> torch.Tensor:
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
    the useful work, and none of it is skipped, as in JAX.

    With ``env``: the ring over the ``model`` axis (``_ring_cells``), q,
    k and v sequence-sharded over ``model`` and batch-sharded over
    ``data``; the flash kernel a step in serving, this math under
    autograd in training."""
    if env is not None:
        spec = sh.seq_spec(env, q.shape[0], 4)
        out = _ring_cells(*(sh.shard(t, spec, env) for t in (q, k, v)),
                          env, causal=causal, window=window)
        return sh.unshard(out, spec, env)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    dev = q.device
    qh, kh, vh = _heads(q, k, v)
    state = _init_state(b * kvh, sq * (h // kvh), hd, dev)
    state = _flash_update(state, qh, kh, vh, torch.arange(sq, device=dev),
                          torch.arange(sk, device=dev), causal, window,
                          h // kvh)
    return _finish(state, b, sq, h, hd, q.dtype)


# ---------------------------------------------------------------------------
# the grid: one tensor per cell, sequence over "model", batch over "data"
# ---------------------------------------------------------------------------

def ring_steps(n: int, s_loc: int, window: int) -> int:
    """The ring's step count: every block, or with a window only the
    min(n, ceil(window / S_loc) + 1) blocks it can reach
    (``attention.py:171-174``)."""
    if window > 0:
        return min(n, -(-window // max(s_loc, 1)) + 1)
    return n


def _combine_lse(acc, out, lse):
    """Step results (out float32, lse) folded in order into acc = (out,
    lse): out weighted by exp(lse_i - lse_total).  A row that has seen no
    key yet has lse = -inf and takes the new step whole."""
    if acc is None:
        return out, lse
    o0, l0 = acc
    tot = torch.logaddexp(l0, lse)
    safe = torch.where(torch.isfinite(tot), tot, torch.zeros_like(tot))
    w0 = torch.exp(l0 - safe)[..., None]
    w1 = torch.exp(lse - safe)[..., None]
    return o0 * w0 + out * w1, tot


def _block_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bidirectional attention of q (B, Sq, H, hd) over one memory block
    k, v (B, Sk, KVH, hd), plain torch as ``cross_attention``: (out
    float32, normalised within the block; lse (B, Sq, H))."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd) * (hd ** -0.5)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), k.float())
    mx = s.amax(-1, keepdim=True)
    p = torch.exp(s - mx)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bqkgs,bskd->bqkgd", p.to(v.dtype).float(),
                       v.float()) / l
    lse = (mx + torch.log(l))[..., 0]
    return out.reshape(b, sq, h, hd), lse.reshape(b, sq, h)


def _ring_cells(qs: sh.Cells, ks: sh.Cells, vs: sh.Cells, env: MeshEnv, *,
                causal: bool, window: int) -> sh.Cells:
    """The ring over ``model`` of JAX's ``ring_attention`` (``attention.py
    :161``) on one tensor per cell: cell r's queries (B_loc, S_loc, H, hd)
    at global positions r·S_loc + i, and at step s the K/V block of rank
    blk = (r - s) mod n, passed one rank on by ``ppermute`` after every
    step; blocks above the causal diagonal are skipped, and a window ends
    the ring after ``ring_steps``.  In serving with S_q = S_kv each step
    is one flash launch (``q_offset = (r - blk) · S_loc``, float32 output
    and lse); in training (grad on) JAX's flash math runs under autograd;
    a memory of another length (cross attention) runs ``_block_attend``.
    Returns each cell's (B_loc, S_loc, H, hd) in q's dtype."""
    n = env.tp_size
    b, s_loc, h, hd = qs[0].shape
    sk, kvh = ks[0].shape[1], ks[0].shape[2]
    ranks = [env.axis_index(c, "model") for c in range(env.n_cells)]
    n_steps = ring_steps(n, s_loc, window)
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (*qs, *ks, *vs))
    if train:
        g = h // kvh
        heads = sh.cellwise(_heads, qs, ks, vs)
        qh, kh, vh = sh.unzip(heads)
        state = sh.cellwise(
            lambda q: _init_state(b * kvh, s_loc * g, hd, q.device), qs)
    else:
        state = [None] * env.n_cells
        kh, vh = ks, vs
    kernel = not train and s_loc == sk
    if not kernel and not train and (causal or window):
        raise ValueError("a masked ring over keys of another length has "
                         "no serving form")
    for step in range(n_steps):
        def one(st, q, k, v, r):
            blk = (r - step) % n
            if causal and blk > r:
                return st                     # above the diagonal
            if train:
                dev = q.device
                return _flash_update(
                    st, q, k, v, r * s_loc + torch.arange(s_loc, device=dev),
                    blk * sk + torch.arange(sk, device=dev), causal, window,
                    h // kvh)
            if kernel:
                out = flash_ops.flash_attention(
                    q, k, v, causal=causal, window=window,
                    q_offset=(r - blk) * s_loc if causal or window else 0,
                    return_lse=True)
            else:
                out = _block_attend(q, k, v)
            return _combine_lse(st, *out)

        state = sh.cellwise(one, state, qh if train else qs, kh, vh, ranks)
        if step + 1 < n_steps:
            kh = sh.ppermute(kh, env, "model", 1)
            vh = sh.ppermute(vh, env, "model", 1)
    if train:
        return sh.cellwise(
            lambda st, q: _finish(st, b, s_loc, h, hd, q.dtype), state, qs)
    return sh.cellwise(lambda st, q: st[0].to(q.dtype), state, qs)


def _decode_cells(qs: sh.Cells, kcs: sh.Cells, vcs: sh.Cells,
                  kns: sh.Cells, vns: sh.Cells,
                  pos: Union[int, torch.Tensor], env: MeshEnv, *,
                  window: int = 0) -> sh.Cells:
    """JAX's split-K ``decode_attention`` (``attention.py:276``) on one
    tensor per cell: cell (d, m) holds the cache positions
    [m·S_loc, (m+1)·S_loc) of its batch rows; it writes the new K/V where
    it owns ``pos`` (in place), runs the decode kernel on its shard at
    ``pos - m·S_loc`` with the lse, and the ``model`` group's float32
    outputs are combined by their lse in rank order on the group's first
    device, then cast and sent to its cells (once per distinct device)."""
    s_loc = kcs[0].shape[1]
    parts: List[Any] = []
    for c in range(env.n_cells):
        dev = env.cells[c]
        local = torch.as_tensor(pos, dtype=torch.int32, device=dev) \
            - env.axis_index(c, "model") * s_loc
        _write_at(kcs[c], kns[c], local)
        _write_at(vcs[c], vns[c], local)
        parts.append(decode_ops.decode_attention(
            qs[c], kcs[c], vcs[c], local, window=window, return_lse=True))
    out: List[Any] = [None] * env.n_cells
    for grp in sh._groups(env, ("model",)):
        dev0 = env.cells[grp[0]]
        acc = None
        for c in grp:
            o, l = parts[c]
            acc = _combine_lse(acc, o.to(dev0), l.to(dev0))
        whole = acc[0].to(qs[grp[0]].dtype)
        sent = {}
        for c in grp:
            dev = env.cells[c]
            if dev not in sent:
                sent[dev] = whole.to(dev)
            out[c] = sent[dev]
    return out


def _window_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kpos: torch.Tensor, pos: torch.Tensor, window: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``window_decode_attention``'s attention over a block of the window's
    slots (no write): (out (B, 1, H, hd) float32 normalised over the
    block, lse (B, 1, H)); a block with no live slot gives 0 and -inf."""
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, 1, kvh, h // kvh, hd) * (hd ** -0.5)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), k.float())
    valid = ((kpos >= 0) & (kpos <= pos) & (kpos > pos - window))[
        None, None, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    total = p.sum(-1, keepdim=True)
    p = p / torch.clamp(total, min=1e-30)
    out = torch.einsum("bqkgs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    lse = torch.where(total > 0, m + torch.log(total),
                      torch.full_like(m, float("-inf")))
    return out.reshape(b, 1, h, hd), lse.reshape(b, 1, h)


def _window_decode_cells(qs: sh.Cells, kcs: sh.Cells, vcs: sh.Cells,
                         kposs: sh.Cells, kns: sh.Cells, vns: sh.Cells,
                         pos: torch.Tensor, env: MeshEnv, *, window: int
                         ) -> sh.Cells:
    """``window_decode_attention`` on one tensor per cell, the rolling
    window's slots cut over ``model`` (``cache_specs``): cell (d, m) holds
    slots [m·W_loc, (m+1)·W_loc) of its batch rows and ``kpos`` whole (W,).
    Each distinct ``kpos`` takes the new position at slot ``pos % W`` in
    place; each cell writes the new K/V where it owns that slot (in place),
    attends over its slots (``_window_partial``), and the ``model``
    group's float32 outputs are combined by their lse in rank order on the
    group's first device, then cast and sent to its cells (once per
    distinct device), as the split-K decode combines the cache shards
    (``_decode_cells``).  JAX's XLA runs the jnp window attention on the
    same shards: no cell gathers the window."""
    w_loc = kcs[0].shape[1]
    w = kposs[0].shape[0]
    for t in {id(t): t for t in kposs}.values():
        p = pos.to(t.device)
        t.index_copy_(0, (p % w).reshape(1).long(), p.reshape(1).to(t.dtype))
    parts: List[Any] = [None] * env.n_cells
    for c in range(env.n_cells):
        dev = env.cells[c]
        p = pos.to(dev)
        lo = env.axis_index(c, "model") * w_loc
        local = p % w - lo
        _write_at(kcs[c], kns[c], local)
        _write_at(vcs[c], vns[c], local)
        parts[c] = _window_partial(qs[c], kcs[c], vcs[c],
                                   kposs[c][lo:lo + w_loc], p, window)
    out: List[Any] = [None] * env.n_cells
    for grp in sh._groups(env, ("model",)):
        dev0 = env.cells[grp[0]]
        acc = None
        for c in grp:
            o, l = parts[c]
            acc = _combine_lse(acc, o.to(dev0), l.to(dev0))
        whole = acc[0].to(qs[grp[0]].dtype)
        sent = {}
        for c in grp:
            dev = env.cells[c]
            if dev not in sent:
                sent[dev] = whole.to(dev)
            out[c] = sent[dev]
    return out
