"""The port's attention against the JAX package's, on the CPU.

The plain flash and decode versions (what a CPU tensor runs through the
kernel wrappers) are held to the JAX Pallas kernels run in interpret mode
and to the JAX refs, at 1e-5 in float32; the model-level forms
(``flash_attention_local``, ``decode_attention`` with its cache write,
``window_decode_attention``) to JAX's ``models/attention.py``.  Inputs
come from a numpy seed and reach both packages as numpy arrays.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.sharding import single_device_env
from repro.kernels.decode_attention.ops import (
    decode_attention as jax_decode_kernel)
from repro.kernels.flash_attention.ops import (
    flash_attention as jax_flash_kernel)
from repro.kernels.flash_attention.ref import (decode_attention_ref,
                                               flash_attention_ref)
from repro.models import attention as jattn
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import attention as tattn

RNG = np.random.default_rng(13)
TOL = 1e-5


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
