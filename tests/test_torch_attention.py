"""The port's attention against the JAX package's, on the CPU.

The plain flash and decode versions (what a CPU tensor runs through the
kernel wrappers) are held to the JAX Pallas kernels run in interpret mode
and to the JAX refs, at 1e-5 in float32; the model-level forms
(``flash_attention_local``, ``decode_attention`` with its cache write,
``window_decode_attention``) to JAX's ``models/attention.py``.  The bf16
tensor-core kernel's arithmetic (p rounded to bf16 before P·V), emulated
here, is held to the Pallas kernel at the JAX tests' bf16 tolerance and to
the plain version at the card's tighter bf16 limit, which fails it with
one KV tile skipped; the decode kernel's split plan is checked for every
cache length up to 40,000.  Inputs come from a numpy seed and reach both packages as numpy
arrays.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.distributed.sharding import single_device_env  # noqa: E402
from repro.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention as jax_decode_kernel)
from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jax_flash_kernel)
from repro.kernels.flash_attention.ref import (decode_attention_ref,  # noqa: E402
                                               flash_attention_ref)
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ops import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

RNG = np.random.default_rng(13)
TOL = 1e-5
# the card's limit for the bf16 kernels, against the plain version run
# in float32 on the same bf16 inputs (tests/test_torch_cuda.py,
# chip_smoke.py)
BF16_ATOL, BF16_RTOL = 5e-3, 1e-2


def _normal(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,h,kvh,hd,window", [
    (1, 128, 4, 4, 32, 0),     # MHA
    (2, 128, 8, 2, 64, 0),     # GQA 4:1
    (1, 256, 5, 1, 64, 0),     # MQA, odd heads
    (1, 192, 4, 2, 32, 50),    # window 50
    (1, 200, 4, 2, 128, 0),    # qwen3's head shape, S not a multiple of 64
])
def test_plain_flash_matches_the_pallas_kernel(b, s, h, kvh, hd, window):
    q, k, v = _normal(b, s, h, hd), _normal(b, s, kvh, hd), \
        _normal(b, s, kvh, hd)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, window=window)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    _close(got, flash_attention_ref(jq, jk, jv, causal=True, window=window))
    # the Pallas kernel reads garbage past a ragged last block, so a
    # ragged S runs as one block
    blk = 64 if s % 64 == 0 else s
    _close(got, jax_flash_kernel(jq, jk, jv, causal=True, window=window,
                                 block_q=blk, block_k=blk, interpret=True))


def _tc_flash_emulation(q, k, v, *, causal, window, drop=None):
    """An emulation, in plain torch, of the bf16 tensor-core flash kernel's
    arithmetic (``csrc/flash_attention.cu``), for bf16 q, k, v.  As there:
    the G query heads of a KV head are packed as rows (row r of a q tile of
    BQ = 128 / G positions, 64 / G at hd 256, is position r / G, head
    r % G); q·k is summed in float32; masked scores are -inf; the online
    softmax runs over 64-key tiles in the log2 domain, p = 2^(s·hd^-0.5·
    log2(e) - m); m moves only when some row of a 16-row m-tile has grown
    by more than 8 (so p reaches 2^8 against a stale m); l sums the float32
    p; p is rounded to bf16 before P·V, which accumulates in float32; the
    output is O·(1/l) rounded to bf16.  ``drop`` = (tile, first position)
    skips that KV tile for every row from that position on, a planted
    fault."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    rows = 128 if hd <= 128 else 64
    bq = rows // g
    n_qt = -(-s // bq)
    c = hd ** -0.5 * 1.4426950408889634
    r = torch.arange(rows)
    qpos = torch.arange(n_qt)[:, None] * bq + r // g            # (T, R)
    qpos = torch.where((r < g * bq) & (qpos < s), qpos, -1)
    t_idx, r_idx = (qpos >= 0).nonzero(as_tuple=True)
    src = (qpos[t_idx, r_idx], r_idx % g)
    qp = torch.zeros(b, kvh, n_qt, rows, hd)
    qp[:, :, t_idx, r_idx] = q.float().reshape(b, s, kvh, g, hd)[
        :, src[0], :, src[1]].permute(1, 2, 0, 3)
    m = torch.full((b, kvh, n_qt, rows), -1e30)
    l = torch.zeros((b, kvh, n_qt, rows))
    o = torch.zeros((b, kvh, n_qt, rows, hd))
    for k0 in range(0, s, 64):
        kt, vt = (x[:, k0:k0 + 64].float().transpose(1, 2) for x in (k, v))
        sc = torch.einsum("bktrd,bknd->bktrn", qp, kt)
        kpos = torch.arange(k0, min(k0 + 64, s))
        ok = (qpos[..., None] >= 0) & (kpos <= qpos[..., None]
                                       if causal else True)
        if window > 0:
            ok = ok & (qpos[..., None] - kpos < window)
        if drop is not None and drop[0] == k0 // 64:
            ok = ok & (qpos[..., None] < drop[1])
        sc = torch.where(ok, sc, -torch.inf)
        mx = sc.amax(-1) * c
        grow = (mx > m + 8).reshape(b, kvh, n_qt, rows // 16, 16).any(-1)
        mn = torch.where(grow.repeat_interleave(16, -1),
                         torch.maximum(m, mx), m)
        coef = torch.exp2(m - mn)
        m = mn
        p = torch.exp2(sc * c - m[..., None])
        l = l * coef + p.sum(-1)
        o = o * coef[..., None] + torch.einsum(
            "bktrn,bknd->bktrd", p.to(torch.bfloat16).float(), vt)
    out = (o * (1.0 / l.clamp_min(1e-30))[..., None]).to(torch.bfloat16)
    res = torch.zeros(b, s, kvh, g, hd, dtype=torch.bfloat16)
    res[:, src[0], :, src[1]] = out[:, :, t_idx, r_idx].permute(2, 0, 1, 3)
    return res.reshape(b, s, h, hd)


def _bf16_inputs(b, s, h, kvh, hd):
    bf16 = ml_dtypes.bfloat16
    return [_normal(*shape).astype(bf16) for shape in
            ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd))]


def _torch_bf16(x):
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _over_bf16_limit(got, q, k, v, *, window):
    """How many elements of a bf16 result lie outside the card's bf16
    limit: the plain version run in float32 on the same bf16 inputs, at
    ``BF16_ATOL`` + ``BF16_RTOL`` · |want|."""
    want = flash_attention(q.float(), k.float(), v.float(), causal=True,
                           window=window)
    return int(((got.float() - want).abs()
                > BF16_ATOL + BF16_RTOL * want.abs()).sum())


@pytest.mark.parametrize("b,s,h,kvh,hd,window", [
    (1, 128, 4, 4, 32, 0),     # MHA
    (2, 128, 8, 2, 64, 0),     # GQA 4:1
    (1, 256, 5, 1, 64, 0),     # MQA, odd heads
    (1, 192, 4, 2, 32, 50),    # window 50
    (1, 200, 4, 2, 128, 0),    # qwen3's head shape, S not a multiple of 64
])
def test_bf16_kernel_arithmetic_matches_the_pallas_kernel(b, s, h, kvh, hd,
                                                         window):
    """Rounding p to bf16 before P·V (as JAX's ``_flash_block`` does, here
    against a stale max, so p up to 2^8) keeps the bf16 kernel's
    arithmetic inside the JAX tests' bf16 tolerance of the Pallas kernel,
    which keeps p in float32, and inside the card's tighter bf16 limit of
    the port's plain version."""
    q, k, v = _bf16_inputs(b, s, h, kvh, hd)
    tq, tk, tv = (_torch_bf16(x) for x in (q, k, v))
    got = _tc_flash_emulation(tq, tk, tv, causal=True, window=window)
    blk = 64 if s % 64 == 0 else s
    want = jax_flash_kernel(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=True, window=window, block_q=blk,
                            block_k=blk, interpret=True)
    assert want.dtype == jnp.bfloat16
    _close(got.float(), np.asarray(want, np.float32), 2e-2)
    assert _over_bf16_limit(got, tq, tk, tv, window=window) == 0


@pytest.mark.parametrize("b,s,h,kvh,hd,drop", [
    (1, 2048, 16, 8, 128, (5, 1984)),   # a mid tile, for the last q tile
    (1, 256, 8, 1, 256, (1, 192)),      # hd 256, G = 8
    (2, 200, 10, 2, 64, (2, 150)),      # G = 5, idle rows
])
def test_bf16_limit_fails_a_dropped_kv_tile(b, s, h, kvh, hd, drop):
    """The bf16 limit that the card tests and chip_smoke.py hold the
    kernels to is tight enough to fail the kernel's arithmetic with one KV
    tile skipped for the last rows only (the served shape's late rows have
    outputs of ~0.05)."""
    tq, tk, tv = (_torch_bf16(x) for x in _bf16_inputs(b, s, h, kvh, hd))
    ok = _tc_flash_emulation(tq, tk, tv, causal=True, window=0)
    bad = _tc_flash_emulation(tq, tk, tv, causal=True, window=0, drop=drop)
    assert _over_bf16_limit(ok, tq, tk, tv, window=0) == 0
    assert _over_bf16_limit(bad, tq, tk, tv, window=0) > 0


@pytest.mark.parametrize("lo,hi", [(1, 2_000), (2_000, 10_000),
                                   (10_000, 40_001)])
def test_split_plan_puts_every_position_in_one_split(lo, hi):
    """For every cache length S in [lo, hi) and B · KVH from one MQA
    sequence to a wide batch: the splits [i·chunk, (i+1)·chunk) cover
    [0, S) with none empty, the chunk is a whole number of tiles, there
    are at most MAX_SPLITS of them, and the grid has at least half the
    CTAs the plan aims for (WAVE_CTAS, or as many as the cap and the tiles
    allow)."""
    tile = decode_ops.TILE
    for n_pairs in (1, 8, 32, 200):
        for s in range(lo, hi):
            n_split, chunk = decode_ops.split_plan(s, n_pairs)
            assert chunk % tile == 0 and chunk > 0
            assert 1 <= n_split <= decode_ops.MAX_SPLITS
            assert (n_split - 1) * chunk < s <= n_split * chunk
            aim = min(decode_ops.WAVE_CTAS,
                      n_pairs * min(decode_ops.MAX_SPLITS, -(-s // tile)))
            assert 2 * n_split * n_pairs >= aim
        for s in (lo, (lo + hi) // 2, hi - 1):
            n_split, chunk = decode_ops.split_plan(s, n_pairs)
            counts = np.bincount(np.arange(s) // chunk, minlength=n_split)
            assert counts.shape == (n_split,) and counts.min() >= 1
            assert counts.sum() == s
    # the served shape keeps the plan it was tuned at
    assert decode_ops.split_plan(2112, 4 * 8) == (11, 192)


@pytest.mark.parametrize("b,s,h,kvh,hd,pos,window", [
    (2, 256, 4, 2, 64, 0, 0),       # first token
    (2, 256, 4, 2, 64, 255, 0),     # full cache
    (1, 384, 6, 1, 32, 100, 0),     # MQA mid-stream
    (1, 512, 4, 2, 32, 300, 64),    # window 64
    (1, 200, 4, 2, 128, 150, 0),    # qwen3's head shape, ragged S
])
def test_plain_decode_matches_the_pallas_kernel(b, s, h, kvh, hd, pos,
                                                window):
    q, kc, vc = _normal(b, 1, h, hd), _normal(b, s, kvh, hd), \
        _normal(b, s, kvh, hd)
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                           torch.from_numpy(vc), pos, window=window)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc)
    _close(got, decode_attention_ref(jq, jk, jv, pos, window=window))
    _close(got, jax_decode_kernel(jq, jk, jv, pos, window=window,
                                  block_k=128 if s % 128 == 0 else s,
                                  interpret=True))
    # a device-scalar pos gives the same answer as an int
    _close(got, decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc),
                                 torch.tensor(pos, dtype=torch.int32),
                                 window=window))


@pytest.mark.parametrize("s,window", [(128, 0), (200, 0), (192, 50)])
def test_flash_attention_local_matches_jax(s, window):
    q, k, v = _normal(2, s, 4, 32), _normal(2, s, 2, 32), _normal(2, s, 2, 32)
    got = tattn.flash_attention_local(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), window=window)
    pos = jnp.arange(s)
    want = jattn.flash_attention_local(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), pos, pos,
                                       causal=True, window=window)
    _close(got, want)


@pytest.mark.parametrize("s,hd,pos", [(128, 32, 90), (200, 128, 150),
                                      (200, 128, 0), (200, 128, 199)])
def test_decode_attention_matches_flash_attention_local(s, hd, pos):
    """The split-K decode (the model's, through the kernel wrapper) equals
    JAX's unsplit flash attention of one query at ``pos``, as
    ``test_kernel_split_k_matches_device_split`` checks for JAX."""
    q, kc, vc = _normal(2, 1, 4, hd), _normal(2, s, 2, hd), \
        _normal(2, s, 2, hd)
    kn, vn = kc[:, pos:pos + 1].copy(), vc[:, pos:pos + 1].copy()
    got, _, _ = tattn.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc.copy()),
        torch.from_numpy(vc.copy()), torch.from_numpy(kn),
        torch.from_numpy(vn), pos)
    want = jattn.flash_attention_local(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.full((1,), pos, jnp.int32), jnp.arange(s), causal=True)
    _close(got, want, 2e-5)


@pytest.mark.parametrize("pos", [0, 63, 64, 100])
def test_decode_attention_cache_write_matches_jax(pos):
    """The cache write at ``pos`` (in place in the port) and the attention
    after it equal JAX's ``decode_attention``; a ``pos`` outside the cache
    (64, 100) writes nothing, as JAX's ``owned`` mask."""
    s = 64
    q, kc, vc = _normal(2, 1, 4, 32), _normal(2, s, 2, 32), _normal(2, s, 2, 32)
    kn, vn = _normal(2, 1, 2, 32), _normal(2, 1, 2, 32)
    env = single_device_env(profile="serve")
    jo, jk, jv = jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
        jnp.asarray(vn), jnp.asarray(pos, jnp.int32), env=env)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    to, tk2, tv2 = tattn.decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(kn),
        torch.from_numpy(vn), torch.tensor(pos, dtype=torch.int32))
    assert tk2 is tk and tv2 is tv              # written in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    if pos >= s:
        np.testing.assert_array_equal(tk.numpy(), kc)
    _close(to, jo)


@pytest.mark.parametrize("pos", [3, 20, 41])
def test_window_decode_attention_matches_jax(pos):
    w, window = 16, 16
    q = _normal(2, 1, 4, 32)
    kc, vc = _normal(2, w, 2, 32), _normal(2, w, 2, 32)
    kpos = np.where(np.arange(w) < min(pos, w),
                    np.arange(w) + max(pos - w, 0), -1).astype(np.int32)
    kn, vn = _normal(2, 1, 2, 32), _normal(2, 1, 2, 32)
    jo, jk, jv, jp = jattn.window_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kpos),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos, jnp.int32),
        window=window)
    to, tk, tv, tp = tattn.window_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc.copy()),
        torch.from_numpy(vc.copy()), torch.from_numpy(kpos.copy()),
        torch.from_numpy(kn), torch.from_numpy(vn), pos, window=window)
    _close(to, jo)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
