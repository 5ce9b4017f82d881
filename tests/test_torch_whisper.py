"""The port's encoder–decoder serving path (whisper: a bidirectional
encoder over stub frame embeddings, decoder layers of self-attention,
cross-attention and FFN) against the JAX package's, on the CPU.

The same numpy inputs from a seed go to the JAX function and the port's:
the sinusoidal positions and cross attention, and whole reduced
whisper models (``cfg.reduced()``: 2 encoder and 2 decoder layers, 8
frames padded to 256, hd 16, float32) with the JAX weights carried over
by ``params_from_jax``.  Tolerances: 1e-5 for functions, 1e-4 for the
float32 model (the port's order of sums against XLA's), 2e-3 for the
prefill/decode consistency check (``tests/test_arch_smoke.py``'s).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.data.lm import make_batch as jax_make_batch  # noqa: E402
from repro.distributed.sharding import set_env, single_device_env  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.lm import encoder_frames, make_batch  # noqa: E402
from repro_torch.distributed.sharding import MeshEnv  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ARCH = "whisper-tiny"
FN_TOL = 1e-5
MODEL_TOL = 1e-4
RNG = np.random.default_rng(41)


@pytest.fixture(scope="module")
def env():
    return single_device_env(profile="serve")


def _close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seq,d", [(1, 2), (256, 64), (1536, 384)])
def test_sinusoidal_positions_match_jax(seq, d):
    got = tlayers.sinusoidal_positions(seq, d)
    assert got.shape == (seq, d) and got.dtype == torch.float32
    _close(got, jlayers.sinusoidal_positions(seq, d), FN_TOL)


@pytest.mark.parametrize("b,sq,skv,h,kvh,hd", [
    (2, 5, 256, 4, 2, 16),     # the reduced decoder over its 256 frames
    (1, 9, 600, 6, 6, 8),      # two of JAX's 512-key chunks, G = 1
    (2, 1, 40, 4, 1, 16),      # one query, MQA
])
def test_cross_attention_matches_jax(b, sq, skv, h, kvh, hd, env):
    q = RNG.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = RNG.normal(size=(b, skv, kvh, hd)).astype(np.float32)
    v = RNG.normal(size=(b, skv, kvh, hd)).astype(np.float32)
    got = tattn.cross_attention(_t(q), _t(k), _t(v))
    want = jattn.cross_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), env=env)
    assert got.shape == (b, sq, h, hd)
    _close(got, want, FN_TOL)


def _pair(seed=0):
    jm = jmodel.build_model(JAX_ARCHS[ARCH].reduced())
    jp = jm.init(jax.random.PRNGKey(seed))
    tcfg = get_arch(ARCH).reduced()
    return jm, jp, build_model(tcfg), params_from_jax(
        tcfg, jax.tree.map(np.asarray, jp))


def _frames(cfg, b):
    return (RNG.normal(size=(b, encoder_frames(cfg), cfg.d_model))
            * 0.02).astype(np.float32)


def _check_caches(tc, jc):
    ks, vs = (np.asarray(a) for a in jc["enc_kv"])
    self_kv = jc["stack"]["0_attn"]
    assert len(tc) == ks.shape[0]
    for i, c in enumerate(tc):
        assert sorted(c) == ["cross_k", "cross_v", "k", "v"]
        _close(c["cross_k"], ks[i])
        _close(c["cross_v"], vs[i])
        for name in ("k", "v"):
            assert tuple(c[name].shape) == self_kv[name].shape[1:]
            _close(c[name], np.asarray(self_kv[name])[i])


def test_prefill_and_decode_match_jax(env):
    jm, jp, tm, tp = _pair()
    b, s, cache_len, steps = 2, 12, 24, 8
    toks = RNG.integers(0, tm.cfg.vocab_size, (b, s + steps)).astype(np.int32)
    frames = _frames(tm.cfg, b)
    with set_env(env):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s]),
                                 "frames": jnp.asarray(frames)}, env,
                            cache_len=cache_len)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks[:, :s]),
                             "frames": _t(frames)}, cache_len=cache_len)
    assert tl.shape == (b, 1, tm.cfg.padded_vocab)
    _close(tl, jl)
    _check_caches(tc, jc)
    for i in range(steps):
        tok = toks[:, s + i:s + i + 1]
        with set_env(env):
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(s + i, jnp.int32), env)
        tl, tc = tm.decode_step(tp, tc, _t(tok), s + i)
        _close(tl, jl)
    _check_caches(tc, jc)


def test_the_frames_reach_the_logits():
    _, _, tm, tp = _pair(seed=1)
    toks = _t(RNG.integers(0, tm.cfg.vocab_size, (2, 6)).astype(np.int32))
    frames = _t(_frames(tm.cfg, 2))
    lg, _ = tm.prefill(tp, {"tokens": toks, "frames": frames})
    lg2, _ = tm.prefill(tp, {"tokens": toks, "frames": frames * 2.0})
    assert float((lg - lg2).abs().max()) > 1e-4


def test_generate_gives_the_greedy_tokens_of_jax(env):
    jm, jp, tm, tp = _pair(seed=3)
    toks = RNG.integers(0, tm.cfg.vocab_size, (2, 16)).astype(np.int32)
    frames = _frames(tm.cfg, 2)
    want = jax_generate(jm, jp, {"tokens": jnp.asarray(toks),
                                 "frames": jnp.asarray(frames)}, env,
                        steps=8, cache_len=24)
    got = serve.generate(tm, tm.cast_params(tp),
                         {"tokens": _t(toks), "frames": _t(frames)},
                         steps=8, cache_len=24)
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_cache_matches_jax_and_decodes_from_it(env):
    """``init_cache`` holds zero cross K/V of ``encoder_frames`` frames, as
    JAX's; decoding from it (no encoder run) gives JAX's logits."""
    jm, jp, tm, tp = _pair(seed=5)
    jc = jm.init_cache(2, 8)
    tc = tm.init_cache(2, 8, "cpu")
    _check_caches(tc, jc)
    assert tc[0]["cross_k"].shape[1] == encoder_frames(tm.cfg) == 256
    toks = RNG.integers(0, tm.cfg.vocab_size, (2, 3)).astype(np.int32)
    for i in range(3):
        with set_env(env):
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                                    jnp.asarray(i, jnp.int32), env)
        tl, tc = tm.decode_step(tp, tc, _t(toks[:, i:i + 1]), i)
        _close(tl, jl)


def test_bf16_decode_cross_attention_follows_jax(env):
    """In bfloat16 the decode step's cross attention takes JAX's order
    (``cross_step``: a float32 softmax, normalised before the cast to
    bf16, then P·V).  The decoder's self-attention ``wo`` and FFN
    ``w_down`` are zeroed on both sides, so the residual stream of a step
    carries the embedding and the cross attention only, and the port
    starts from JAX's caches: bf16 rounding elsewhere (the encoder, the
    self-attention and FFN products, whose sum orders the port does not
    follow bit for bit) drops out.  Both decode sites are held: the one
    device step and the grid step (``env``, a (2, 1) grid of CPU cells, one
    row a cell), the grid in both profiles: the train profile cuts each
    weight's contraction dim over ``data``, so the weight-stationary step
    adds float32 partial products and rounds once; the serve profile
    keeps the weights whole on the one ``model`` rank.  Measured on the
    CPU over 6 steps: the logits of all three equal JAX's (max abs err 0);
    normalising after P·V, as the prefill's ``cross_attention`` does,
    gave a max abs err of 0.0039 at either site reverted alone."""
    jcfg = dataclasses.replace(JAX_ARCHS[ARCH].reduced(), dtype="bfloat16")
    tcfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="bfloat16")
    jm = jmodel.build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    dec = jp["stack"]["0_attn"]
    dec["attn"]["wo"] = jnp.zeros_like(dec["attn"]["wo"])
    dec["mlp"]["w_down"] = jnp.zeros_like(dec["mlp"]["w_down"])
    tm = build_model(tcfg)
    tp = tm.cast_params(params_from_jax(tcfg, jax.tree.map(np.asarray, jp)))
    rng = np.random.default_rng(0)
    b, s, steps = 2, 12, 6
    toks = rng.integers(0, tcfg.vocab_size, (b, s + steps)).astype(np.int32)
    frames = (rng.normal(size=(b, encoder_frames(tcfg), tcfg.d_model))
              * 0.02).astype(np.float32)
    with set_env(env):
        _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s]),
                                "frames": jnp.asarray(frames)}, env,
                           cache_len=s + steps)

    def bf16(a):
        return torch.tensor(np.asarray(a, np.float32), dtype=torch.bfloat16)
    ks, vs = jc["enc_kv"]
    self_kv = jc["stack"]["0_attn"]
    tc = [{"cross_k": bf16(ks[i]), "cross_v": bf16(vs[i]),
           "k": bf16(self_kv["k"][i]), "v": bf16(self_kv["v"][i])}
          for i in range(tcfg.n_layers)]
    grids = {prof: MeshEnv([["cpu"], ["cpu"]], profile=prof)  # a row a cell
             for prof in ("train", "serve")}
    gcs = {prof: tm.shard_caches(tc, g, b) for prof, g in grids.items()}
    err = {"one device": 0.0, "grid train": 0.0, "grid serve": 0.0}
    for i in range(steps):
        tok = toks[:, s + i:s + i + 1]
        with set_env(env):
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(s + i, jnp.int32), env)
        tl, tc = tm.decode_step(tp, tc, _t(tok), s + i)
        outs = {"one device": tl}
        for prof, g in grids.items():
            outs[f"grid {prof}"], gcs[prof] = tm.decode_step(
                tp, gcs[prof], _t(tok), s + i, env=g)
        for key, got in outs.items():
            assert got.dtype == torch.float32
            err[key] = max(err[key], float(np.abs(
                got.numpy() - np.asarray(jl, np.float32)).max()))
    assert max(err.values()) <= 1e-3, err


def test_prefill_decode_consistency():
    """decode_step(prefill(t[:S])) logits == prefill(t[:S+1]) logits over
    the same frames, at the JAX package's 2e-3."""
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg)
    params = model.cast_params(model.init(torch.Generator().manual_seed(1)))
    batch = make_batch(cfg, 2, 25, seed=1, cursor=0)
    full, frames = batch["tokens"], batch["frames"]
    lg, caches = model.prefill(params, {"tokens": full[:, :24],
                                        "frames": frames}, cache_len=28)
    lg_dec, _ = model.decode_step(params, caches, full[:, 24:], 24)
    lg_full, _ = model.prefill(params, {"tokens": full, "frames": frames})
    _close(lg_dec[:, 0], lg_full[:, 0], 2e-3)
    assert torch.isfinite(lg).all()


def test_make_batch_carries_the_frame_stub():
    cfg = get_arch(ARCH)
    a = make_batch(cfg, 2, 16, seed=0, cursor=0)
    assert sorted(a) == ["frames", "labels", "tokens"]
    assert a["frames"].shape == (2, 1536, 384) == (2, encoder_frames(cfg),
                                                   cfg.d_model)
    assert abs(float(a["frames"].std()) - 0.02) < 0.001
    assert torch.equal(a["frames"], make_batch(cfg, 2, 16, 0, 0)["frames"])
    want = jax_make_batch(JAX_ARCHS[ARCH].reduced(), 2, 16, 0, 0)
    got = make_batch(get_arch(ARCH).reduced(), 2, 16, 0, 0)
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape


def test_params_from_jax_and_cast_params_follow_the_jax_layout():
    """``enc_stack`` and ``cross_stack`` become per-layer lists in layer
    order; in bf16 every leaf of them is cast (JAX stacks them), while
    ``enc_norm`` and ``final_norm`` stay float32."""
    jcfg = dataclasses.replace(JAX_ARCHS[ARCH].reduced(), dtype="bfloat16")
    tcfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="bfloat16")
    jm = jmodel.build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg)
    got = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    ref = tm.init(torch.Generator().manual_seed(0))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (tuple(t.shape), t.dtype)
    assert shapes(got) == shapes(ref)
    assert len(got["enc_layers"]) == 2 and len(got["cross_layers"]) == 2
    np.testing.assert_array_equal(
        got["cross_layers"][1]["attn"]["wk"].numpy(),
        np.asarray(jp["cross_stack"]["attn"]["wk"][1]))
    is_bf16 = jax.tree.map(
        lambda x: np.full(x.shape, x.dtype == jnp.bfloat16, np.float32),
        jmodel.cast_params(jp, jnp.bfloat16))
    want = params_from_jax(tcfg, is_bf16)
    cast = tm.cast_params(got)

    def walk(g, w, path):
        if isinstance(g, dict):
            for k in g:
                walk(g[k], w[k], path + (k,))
        elif isinstance(g, list):
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, path + (i,))
        else:
            bf = bool(w.flatten()[0])
            assert g.dtype == (torch.bfloat16 if bf else torch.float32), path
    walk(cast, want, ())
    assert cast["enc_layers"][0]["norm1"]["scale"].dtype == torch.bfloat16
    assert cast["enc_norm"]["scale"].dtype == torch.float32
    batch = make_batch(tcfg, 1, 8, 0, 0)
    lg, _ = tm.prefill(cast, batch)
    assert lg.dtype == torch.float32 and bool(torch.isfinite(lg).all())


def test_serve_main_runs_whisper_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert "whisper-tiny-reduced on cpu: generated (2, 4)" in out
