"""The port's recurrentgemma (RG-LRU / local-attention hybrid) serving
path against the JAX package's, on the CPU.

The same numpy inputs from a seed go to the JAX function and the port's:
the conv4 and RG-LRU sequence and decode functions, and whole reduced
hybrid models (``cfg.reduced()``: (rec, rec, local) + a rec tail, hd 16,
window 16, float32) with the JAX weights carried over by
``params_from_jax``.  Prompts shorter and longer than the window, and a
cache shorter than the window, reach every branch of the rolling-window
cache.  Tolerances: 1e-5 + 1e-5·|want| for functions (the port's scan
associates in another order than ``lax.associative_scan``), 1e-4 for the
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
from repro.distributed.sharding import set_env, single_device_env  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.lm import make_batch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

FN_TOL = 1e-5
MODEL_TOL = 1e-4
ARCH = "recurrentgemma-9b"
RNG = np.random.default_rng(31)


@pytest.fixture(scope="module")
def env():
    return single_device_env(profile="serve")


def _close(got, want, tol=FN_TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# (a) conv4 and the RG-LRU
# ---------------------------------------------------------------------------

def _rglru_weights(dr):
    """w_rg, b_rg, w_ig, b_ig, conv_w, conv_b, lam as numpy float32."""
    w = [(RNG.normal(size=(dr, dr)) * dr ** -0.5).astype(np.float32)
         for _ in range(2)]
    b = [(RNG.normal(size=dr) * 0.1).astype(np.float32) for _ in range(2)]
    conv_w = (RNG.normal(size=(4, dr)) * 0.1).astype(np.float32)
    conv_b = (RNG.normal(size=dr) * 0.1).astype(np.float32)
    lam = RNG.uniform(-1.0, 2.0, dr).astype(np.float32)
    return w[0], b[0], w[1], b[1], conv_w, conv_b, lam


def test_causal_conv4_matches_jax():
    b, s, dr = 2, 9, 12
    x = RNG.normal(size=(b, s, dr)).astype(np.float32)
    w = RNG.normal(size=(4, dr)).astype(np.float32)
    bias = RNG.normal(size=dr).astype(np.float32)
    tail = RNG.normal(size=(b, 3, dr)).astype(np.float32)
    got = trec.causal_conv4(_t(x), _t(w), _t(bias), _t(tail))
    want = jrec._causal_conv4(*map(jnp.asarray, (x, w, bias, tail)))
    assert got.shape == (b, s, dr)
    _close(got, want)


# S = 1; 7 (not a power of 2); 64; 300 (nine doubling steps)
@pytest.mark.parametrize("s", [1, 7, 64, 300])
def test_rglru_seq_matches_jax(s, env):
    b, dr = 2, 16
    x = RNG.normal(size=(b, s, dr)).astype(np.float32)
    w = _rglru_weights(dr)
    got = trec.rglru_seq(_t(x), *map(_t, w))
    want = jrec.rglru_seq(jnp.asarray(x), *map(jnp.asarray, w), env=env)
    assert got.shape == (b, s, dr) and got.dtype == torch.float32
    _close(got, want)


def test_linear_scan_is_the_recurrence():
    """The doubling scan against the step-by-step loop h = a·h + x, with
    a near 0 and near 1 (no overflow, no underflow to NaN)."""
    a = np.concatenate([RNG.uniform(0.0, 1e-3, (2, 50, 4)),
                        RNG.uniform(0.999, 1.0, (2, 50, 4))], axis=1)
    x = RNG.normal(size=(2, 100, 4))
    want = np.zeros_like(x)
    h = np.zeros((2, 4))
    for t in range(100):
        h = a[:, t] * h + x[:, t]
        want[:, t] = h
    got = trec.linear_scan(_t(a), _t(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_rglru_seq_keeps_the_bf16_model_dtypes(env):
    """bf16 input and bf16-cast weights (the served model's): the gates and
    the scan run in float32 from the bf16 values, h comes back in bf16,
    equal to JAX's to one bf16 rounding (2^-7 relative)."""
    b, s, dr = 2, 40, 16
    x = RNG.normal(size=(b, s, dr)).astype(np.float32)
    w = _rglru_weights(dr)
    got = trec.rglru_seq(_t(x).bfloat16(),
                         *[_t(a).bfloat16() for a in w])
    want = jrec.rglru_seq(jnp.asarray(x, jnp.bfloat16),
                          *[jnp.asarray(a, jnp.bfloat16) for a in w],
                          env=env)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got.float(), np.asarray(want.astype(jnp.float32)), 2 ** -7)


def test_rglru_decode_step_matches_jax():
    b, dr = 3, 16
    h0 = RNG.normal(size=(b, dr)).astype(np.float32)
    tail = RNG.normal(size=(b, 3, dr)).astype(np.float32)
    x = RNG.normal(size=(b, dr)).astype(np.float32)
    w = _rglru_weights(dr)
    (h, new_tail), out = trec.rglru_decode_step((_t(h0), _t(tail)), _t(x),
                                                *map(_t, w))
    (jh, jtail), jout = jrec.rglru_decode_step(
        (jnp.asarray(h0), jnp.asarray(tail)), jnp.asarray(x),
        *map(jnp.asarray, w))
    _close(out, jout)
    _close(h, jh)
    _close(new_tail, jtail)


def test_rglru_decode_continues_the_sequence(env):
    """rglru_seq over S + 1 inputs ends where S steps of the sequence and
    one decode step from its final state and tail end."""
    b, s, dr = 2, 20, 16
    x = RNG.normal(size=(b, s + 1, dr)).astype(np.float32)
    w = [_t(a) for a in _rglru_weights(dr)]
    full = trec.rglru_seq(_t(x), *w)
    hs = trec.rglru_seq(_t(x[:, :s]), *w)
    _, last = trec.rglru_decode_step((hs[:, -1], _t(x[:, s - 3:s])),
                                     _t(x[:, s]), *w)
    _close(last, full[:, -1])


# ---------------------------------------------------------------------------
# (b) whole reduced models
# ---------------------------------------------------------------------------

def _cfgs(n_layers=None, dtype="float32"):
    j, t = JAX_ARCHS[ARCH].reduced(), get_arch(ARCH).reduced()
    n_layers = n_layers or t.n_layers
    return (dataclasses.replace(j, n_layers=n_layers, dtype=dtype),
            dataclasses.replace(t, n_layers=n_layers, dtype=dtype))


def _pair(n_layers=None, seed=0):
    jcfg, tcfg = _cfgs(n_layers)
    jm = jmodel.build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, build_model(tcfg), \
        params_from_jax(tcfg, jax.tree.map(np.asarray, jp))


def _jax_layer_caches(jcache, tm):
    """JAX's caches (stacked per pattern position, plus the tail) in the
    port's layer order."""
    pattern = tm.cfg.block_pattern
    groups = tm.cfg.n_layers // len(pattern)
    out = [{k: np.asarray(v)[g]
            for k, v in jcache["stack"][f"{j}_{kind}"].items()}
           for g in range(groups) for j, kind in enumerate(pattern)]
    tail = pattern[:tm.cfg.n_layers % len(pattern)]
    out += [{k: np.asarray(v)
             for k, v in jcache["tail"][f"{j}_{kind}"].items()}
            for j, kind in enumerate(tail)]
    return out


def _check_caches(tc, jc, tm):
    want = _jax_layer_caches(jc, tm)
    assert len(tc) == len(want) == tm.cfg.n_layers
    for kind, got, ref in zip(tm.kinds, tc, want):
        assert sorted(got) == sorted(ref) == {
            "rec": ["h", "tail"], "local": ["k", "kpos", "v"]}[kind]
        for name in ref:
            assert tuple(got[name].shape) == ref[name].shape, (kind, name)
            if name == "kpos":
                assert got[name].dtype == torch.int32
                np.testing.assert_array_equal(got[name].numpy(), ref[name])
            else:
                _close(got[name], ref[name], MODEL_TOL)


# prompt shorter than the window (16) and than a cache of 18; longer than
# the window; a cache shorter than the window (a ring of 12 slots)
PROMPTS = [(10, 18), (40, 48), (6, 12)]


@pytest.mark.parametrize("s,cache_len", PROMPTS)
def test_prefill_and_decode_match_jax(s, cache_len, env):
    jm, jp, tm, tp = _pair()
    assert tm.kinds == ("rec", "rec", "local", "rec")
    b, steps = 2, 8
    toks = RNG.integers(0, tm.cfg.vocab_size, (b, s + steps)).astype(np.int32)
    with set_env(env):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, env,
                            cache_len=cache_len)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks[:, :s])}, cache_len=cache_len)
    assert tl.shape == (b, 1, tm.cfg.padded_vocab)
    _close(tl, jl, MODEL_TOL)
    _check_caches(tc, jc, tm)
    for i in range(steps):
        tok = toks[:, s + i:s + i + 1]
        with set_env(env):
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(s + i, jnp.int32), env)
        tl, tc = tm.decode_step(tp, tc, _t(tok), s + i)
        _close(tl, jl, MODEL_TOL)
    _check_caches(tc, jc, tm)


@pytest.mark.parametrize("s", [10, 40])
def test_generate_gives_the_greedy_tokens_of_jax(s, env):
    jm, jp, tm, tp = _pair(seed=3)
    toks = RNG.integers(0, tm.cfg.vocab_size, (2, s)).astype(np.int32)
    want = jax_generate(jm, jp, {"tokens": jnp.asarray(toks)}, env,
                        steps=8, cache_len=s + 8)
    got = serve.generate(tm, tm.cast_params(tp), {"tokens": _t(toks)},
                         steps=8, cache_len=s + 8)
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_cache_matches_jax_and_decodes_from_it(env):
    jm, jp, tm, tp = _pair(seed=5)
    jc = jm.init_cache(2, 24)
    tc = tm.init_cache(2, 24, "cpu")
    for got, ref in zip(tc, _jax_layer_caches(jc, tm)):
        assert sorted(got) == sorted(ref)
        for name in ref:
            assert tuple(got[name].shape) == ref[name].shape
            np.testing.assert_array_equal(got[name].numpy(), ref[name])
    toks = RNG.integers(0, tm.cfg.vocab_size, (2, 20)).astype(np.int32)
    for i in range(20):                      # past the window of 16
        with set_env(env):
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                                    jnp.asarray(i, jnp.int32), env)
        tl, tc = tm.decode_step(tp, tc, _t(toks[:, i:i + 1]), i)
        _close(tl, jl, MODEL_TOL)
    _check_caches(tc, jc, tm)


@pytest.mark.parametrize("s", [10, 40])
def test_prefill_decode_consistency(s):
    """decode_step(prefill(t[:S])) logits == prefill(t[:S+1]) logits, the
    JAX package's own check (``test_arch_smoke.py``) at its 2e-3, with
    the prompt inside and past the window."""
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg)
    params = model.cast_params(model.init(torch.Generator().manual_seed(1)))
    full = make_batch(cfg, 2, s + 1, seed=1, cursor=0)["tokens"]
    lg, caches = model.prefill(params, {"tokens": full[:, :s]},
                               cache_len=s + 4)
    lg_dec, _ = model.decode_step(params, caches, full[:, s:s + 1], s)
    lg_full, _ = model.prefill(params, {"tokens": full})
    _close(lg_dec[:, 0], lg_full[:, 0], 2e-3)
    assert torch.isfinite(lg).all()


def test_a_prompt_under_three_tokens_leaves_a_full_conv_tail():
    """JAX keeps xin[:, -3:] as the tail, which is short after a prompt
    of 1 or 2 tokens; the port pads it with zeros on the left (the
    conv's history before position 0), so decode continues the prefill."""
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(2))
    full = make_batch(cfg, 2, 3, seed=2, cursor=0)["tokens"]
    _, caches = model.prefill(params, {"tokens": full[:, :2]}, cache_len=8)
    assert caches[0]["tail"].shape == (2, 3, cfg.d_model)
    assert float(caches[0]["tail"][:, 0].abs().max()) == 0.0
    lg_dec, _ = model.decode_step(params, caches, full[:, 2:], 2)
    lg_full, _ = model.prefill(params, {"tokens": full})
    _close(lg_dec, lg_full, 2e-3)


@pytest.mark.parametrize("n_layers", [4, 5])
def test_params_from_jax_takes_the_hybrid_layout(n_layers):
    """Stacked groups of ("0_rec", "1_rec", "2_local") and a tail of
    ("0_rec",) or ("0_rec", "1_rec") (recurrentgemma-9b's own 38 layers
    are 12 groups and the second tail): the layers come out in layer
    order with every leaf of ``Model.init``'s shape."""
    jcfg, tcfg = _cfgs(n_layers)
    jp = jmodel.build_model(jcfg).init(jax.random.PRNGKey(0))
    assert sorted(jp["tail"]) == ["0_rec", "1_rec"][:n_layers - 3]
    got = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    ref = build_model(tcfg).init(torch.Generator().manual_seed(0))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (tuple(t.shape), t.dtype)
    assert shapes(got) == shapes(ref)
    np.testing.assert_array_equal(got["layers"][3]["conv_w"].numpy(),
                                  np.asarray(jp["tail"]["0_rec"]["conv_w"]))
    np.testing.assert_array_equal(got["layers"][1]["lam"].numpy(),
                                  np.asarray(jp["stack"]["1_rec"]["lam"][0]))
    lam = ref["layers"][0]["lam"]
    assert torch.equal(lam, torch.full_like(lam, 0.7))
    conv = torch.cat([p["conv_w"].flatten() for p in ref["layers"]
                      if "conv_w" in p])
    assert abs(float(conv.std()) - 0.1) < 0.02


def test_init_with_cast_is_cast_params_of_init():
    """``init(gen, cast=True)`` draws the same weights as ``init(gen)`` and
    casts them as ``cast_params`` does, layer by layer."""
    _, tcfg = _cfgs(5, dtype="bfloat16")
    m = build_model(tcfg)
    want = m.cast_params(m.init(torch.Generator().manual_seed(4)))
    got = m.init(torch.Generator().manual_seed(4), cast=True)

    def leaves(t, path=()):
        if isinstance(t, dict):
            for k in t:
                yield from leaves(t[k], path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from leaves(v, path + (i,))
        else:
            yield path, t
    a, b = dict(leaves(got)), dict(leaves(want))
    assert a.keys() == b.keys()
    for path in a:
        assert a[path].dtype == b[path].dtype and \
            torch.equal(a[path], b[path]), path
    assert a[("layers", 0, "lam")].dtype == torch.bfloat16      # stacked
    assert a[("layers", 4, "lam")].dtype == torch.float32       # the tail


def test_cast_params_gives_every_leaf_the_jax_dtype():
    """In bf16 JAX casts every float32 leaf that is >= 2-D in its layout:
    every leaf of a stacked layer (``lam``, ``conv_b``, ``b_rg``, norm
    scales), the tail's and the top level's matrices only; the bf16
    hybrid then runs."""
    jcfg, tcfg = _cfgs(5, dtype="bfloat16")
    jm = jmodel.build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    is_bf16 = jax.tree.map(
        lambda x: np.full(x.shape, x.dtype == jnp.bfloat16, np.float32),
        jmodel.cast_params(jp, jnp.bfloat16))
    want = params_from_jax(tcfg, is_bf16)
    tm = build_model(tcfg)
    got = tm.cast_params(params_from_jax(tcfg, jax.tree.map(np.asarray, jp)))
    for i, (g, w) in enumerate(zip(got["layers"], want["layers"])):
        for name in g:
            if isinstance(g[name], dict):
                continue
            bf = bool(w[name].flatten()[0])
            assert g[name].dtype == (torch.bfloat16 if bf
                                     else torch.float32), (i, name)
    assert got["layers"][0]["lam"].dtype == torch.bfloat16
    assert got["layers"][4]["lam"].dtype == torch.float32
    lg, caches = tm.prefill(got, {"tokens": torch.zeros((1, 20),
                                                        dtype=torch.int32)})
    assert lg.dtype == torch.float32 and bool(torch.isfinite(lg).all())
    assert caches[0]["h"].dtype == torch.float32 and \
        caches[2]["k"].dtype == torch.bfloat16


def test_serve_main_runs_the_hybrid_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "20", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert "recurrentgemma-9b-reduced on cpu: generated (2, 4)" in out
