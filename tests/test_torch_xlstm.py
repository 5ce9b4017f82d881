"""The port's xLSTM serving path against the JAX package's, on the CPU.

The same numpy inputs from a seed go to the JAX function and the port's:
the sLSTM scan (the plain version the port's wrapper takes on a CPU
tensor, against the Pallas kernel in interpret mode and its reference),
the mLSTM/sLSTM sequence, decode and final-state functions, and whole
reduced xLSTM models with the JAX weights carried over by
``params_from_jax``.  Tolerances: 1e-5 for functions, 1e-4 for the
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
from repro.kernels.slstm_scan.ops import slstm_scan as jax_slstm_scan  # noqa: E402
from repro.kernels.slstm_scan.ref import slstm_scan_ref as jax_slstm_scan_ref  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.lm import make_batch  # noqa: E402
from repro_torch.kernels.slstm_scan import ops as slstm_ops  # noqa: E402
from repro_torch.kernels.slstm_scan.ref import zero_state  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

FN_TOL = 1e-5
MODEL_TOL = 1e-4
ARCH = "xlstm-1.3b"
RNG = np.random.default_rng(23)


@pytest.fixture(scope="module")
def env():
    return single_device_env(profile="serve")


def _close(got, want, tol=FN_TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(b, h, hd, nonzero):
    """(c, n, h, m) as numpy: a fresh state, or one a few steps in."""
    if not nonzero:
        z = np.zeros((b, h, hd), np.float32)
        return z, z, z, np.full((b, h, hd), -1e30, np.float32)
    return (RNG.normal(size=(b, h, hd)).astype(np.float32),
            RNG.uniform(0.5, 2.0, (b, h, hd)).astype(np.float32),
            RNG.normal(size=(b, h, hd)).astype(np.float32) * 0.5,
            RNG.normal(size=(b, h, hd)).astype(np.float32))


# ---------------------------------------------------------------------------
# (a) the sLSTM scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,b,h,hd,chunk", [
    (32, 2, 2, 16, 8),     # multi-chunk
    (64, 4, 4, 32, 64),    # single chunk
    (48, 1, 3, 8, 16),     # odd head count, B=1
])
def test_slstm_scan_matches_the_pallas_kernel(s, b, h, hd, chunk):
    """tests/test_kernels.py's shapes: the port's scan (batch-major) against
    the Pallas kernel in interpret mode (time-major)."""
    xpre = (RNG.normal(size=(s, b, 4, h, hd)) * 0.5).astype(np.float32)
    r = (RNG.normal(size=(h, hd, 4 * hd)) * hd ** -0.5).astype(np.float32)
    want = jax_slstm_scan(jnp.asarray(xpre), jnp.asarray(r), chunk=chunk,
                          interpret=True)
    st = [_t(a) for a in _state(b, h, hd, False)]
    got, _ = slstm_ops.slstm_scan(_t(xpre).transpose(0, 1), _t(r), *st)
    assert got.shape == (b, s, h, hd) and got.dtype == torch.float32
    _close(got.transpose(0, 1), want)


@pytest.mark.parametrize("s,b,h,hd", [(20, 2, 2, 16), (1, 3, 3, 8)])
def test_slstm_scan_from_a_nonzero_state_matches_the_reference(s, b, h, hd):
    """h for every step and the final (c, n, h, m), against the JAX
    reference ``slstm_scan_ref``; S = 1 is the decode step."""
    xpre = (RNG.normal(size=(s, b, 4, h, hd)) * 0.5).astype(np.float32)
    r = (RNG.normal(size=(h, hd, 4 * hd)) * hd ** -0.5).astype(np.float32)
    st = _state(b, h, hd, True)
    want_h, want_st = jax_slstm_scan_ref(jnp.asarray(xpre), jnp.asarray(r),
                                         *map(jnp.asarray, st))
    got_h, got_st = slstm_ops.slstm_scan(_t(xpre.transpose(1, 0, 2, 3, 4)),
                                         _t(r), *map(_t, st))
    _close(got_h.transpose(0, 1), want_h)
    for g, w in zip(got_st, want_st):
        assert g.dtype == torch.float32
        _close(g, w)


def test_slstm_scan_wrapper_refuses_bad_shapes():
    st = zero_state(2, 2, 8, "cpu")
    x = torch.zeros((2, 5, 4, 2, 8))
    with pytest.raises(ValueError):
        slstm_ops.slstm_scan(x, torch.zeros((2, 8, 8)), *st)
    with pytest.raises(ValueError):
        slstm_ops.slstm_scan(x[:, :0], torch.zeros((2, 8, 32)), *st)
    with pytest.raises(ValueError):
        slstm_ops.slstm_scan(x, torch.zeros((2, 8, 32)), *st[:3],
                             torch.zeros((2, 2, 4)))


# ---------------------------------------------------------------------------
# (b) the recurrent functions
# ---------------------------------------------------------------------------

def _mlstm_inputs(b, s, h, hd):
    q, k, v = (RNG.normal(size=(b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    i_raw = RNG.normal(size=(b, s, h)).astype(np.float32)
    f_raw = (RNG.normal(size=(b, s, h)) + 3.0).astype(np.float32)
    return q, k, v, i_raw, f_raw


# S = 24; 257 (prime: chunks of length 1); 300 (two chunks of 150)
SEQ_LENS = [24, 257, 300]


@pytest.mark.parametrize("s", SEQ_LENS)
def test_mlstm_seq_and_final_state_match_jax(s, env):
    args = _mlstm_inputs(2, s, 2, 8)
    jargs = [jnp.asarray(a) for a in args]
    targs = [_t(a) for a in args]
    _close(trec.mlstm_seq(*targs), jrec.mlstm_seq(*jargs, env=env))
    got, (c, n) = trec.mlstm_with_state(*targs)
    want, (jc, jn) = jmodel._mlstm_with_state(*jargs, env)
    _close(got, want)
    _close(c, jc)
    _close(n, jn)


def test_mlstm_decode_step_matches_jax():
    b, h, hd = 2, 3, 8
    c0 = RNG.normal(size=(b, h, hd, hd)).astype(np.float32)
    n0 = RNG.normal(size=(b, h, hd)).astype(np.float32)
    q, k, v = (RNG.normal(size=(b, h, hd)).astype(np.float32)
               for _ in range(3))
    i_raw, f_raw = (RNG.normal(size=(b, h)).astype(np.float32)
                    for _ in range(2))
    (c, n), out = trec.mlstm_decode_step(
        (_t(c0), _t(n0)), *map(_t, (q, k, v, i_raw, f_raw)))
    (jc, jn), jout = jrec.mlstm_decode_step(
        (jnp.asarray(c0), jnp.asarray(n0)),
        *map(jnp.asarray, (q, k, v, i_raw, f_raw)))
    _close(out, jout)
    _close(c, jc)
    _close(n, jn)


@pytest.mark.parametrize("s", SEQ_LENS)
def test_slstm_seq_and_final_state_match_jax(s, env):
    b, h, hd = 2, 2, 8
    xpre = (RNG.normal(size=(b, s, 4, h, hd)) * 0.5).astype(np.float32)
    r = (RNG.normal(size=(h, hd, 4 * hd)) * hd ** -0.5).astype(np.float32)
    _close(trec.slstm_seq(_t(xpre), _t(r)),
           jrec.slstm_seq(jnp.asarray(xpre), jnp.asarray(r), env=env))
    got, st = trec.slstm_with_state(_t(xpre), _t(r))
    want, jst = jmodel._slstm_with_state(jnp.asarray(xpre), jnp.asarray(r),
                                         env)
    _close(got, want)
    for g, w in zip(st, jst):
        _close(g, w)


def test_slstm_seq_keeps_the_bf16_model_dtypes(env):
    """bf16 xpre and a bf16 R (the served model's): h comes back in bf16,
    equal to JAX's to one bf16 rounding (2^-7 relative)."""
    b, s, h, hd = 2, 16, 2, 8
    xpre = (RNG.normal(size=(b, s, 4, h, hd)) * 0.5).astype(np.float32)
    r = (RNG.normal(size=(h, hd, 4 * hd)) * hd ** -0.5).astype(np.float32)
    got = trec.slstm_seq(_t(xpre).bfloat16(), _t(r).bfloat16())
    want = jrec.slstm_seq(jnp.asarray(xpre, jnp.bfloat16),
                          jnp.asarray(r, jnp.bfloat16), env=env)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got.float(), np.asarray(want.astype(jnp.float32)), 2 ** -7)


def test_slstm_decode_step_matches_jax():
    b, h, hd = 3, 2, 8
    st = _state(b, h, hd, True)
    xt = (RNG.normal(size=(b, 4, h, hd)) * 0.5).astype(np.float32)
    r = (RNG.normal(size=(h, hd, 4 * hd)) * hd ** -0.5).astype(np.float32)
    got_st, got = trec.slstm_decode_step(tuple(map(_t, st)), _t(xt), _t(r))
    want_st, want = jrec.slstm_decode_step(tuple(map(jnp.asarray, st)),
                                           jnp.asarray(xt), jnp.asarray(r))
    _close(got, want)
    for g, w in zip(got_st, want_st):
        _close(g, w)


def test_the_einsums_stay_two_operand_without_opt_einsum(env):
    """The card's torch has no opt_einsum: the recurrent functions must give
    the same answer with it switched off."""
    args = _mlstm_inputs(2, 40, 2, 8)
    before = torch.backends.opt_einsum.enabled
    torch.backends.opt_einsum.enabled = False
    try:
        got, (c, n) = trec.mlstm_with_state(*map(_t, args))
    finally:
        torch.backends.opt_einsum.enabled = before
    want, (jc, jn) = jmodel._mlstm_with_state(*map(jnp.asarray, args), env)
    _close(got, want)
    _close(c, jc)
    _close(n, jn)


# ---------------------------------------------------------------------------
# (c)-(f) whole models
# ---------------------------------------------------------------------------

# xlstm-1.3b reduced: (m, m, s) x 1; x 2 (two groups); x 2 + an "m" tail
N_LAYERS = [3, 6, 7]


def _cfgs(n_layers, dtype="float32"):
    j = dataclasses.replace(JAX_ARCHS[ARCH].reduced(), n_layers=n_layers,
                            dtype=dtype)
    t = dataclasses.replace(get_arch(ARCH).reduced(), n_layers=n_layers,
                            dtype=dtype)
    return j, t


def _pair(n_layers, seed=0):
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


@pytest.mark.parametrize("n_layers", N_LAYERS)
def test_prefill_and_decode_match_jax(n_layers, env):
    jm, jp, tm, tp = _pair(n_layers)
    assert [k for k in tm.kinds] == (["m", "m", "s"] * 3)[:n_layers]
    b, s, steps = 2, 24, 8
    toks = RNG.integers(0, tm.cfg.vocab_size, (b, s + steps)).astype(np.int32)
    with set_env(env):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, env,
                            cache_len=s + steps)
    tl, tc = tm.prefill(tp, {"tokens": _t(toks[:, :s])}, cache_len=s + steps)
    assert tl.shape == (b, 1, tm.cfg.padded_vocab)
    _close(tl, jl, MODEL_TOL)
    want = _jax_layer_caches(jc, tm)
    assert len(tc) == len(want) == n_layers
    for kind, got, ref in zip(tm.kinds, tc, want):
        assert sorted(got) == sorted(ref) == (
            ["c", "n"] if kind == "m" else ["c", "h", "m", "n"])
        for name in ref:
            assert got[name].dtype == torch.float32
            _close(got[name], ref[name], MODEL_TOL)
    for i in range(steps):
        tok = toks[:, s + i:s + i + 1]
        with set_env(env):
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(s + i, jnp.int32), env)
        tl, tc = tm.decode_step(tp, tc, _t(tok), s + i)
        _close(tl, jl, MODEL_TOL)
    for got, ref in zip(tc, _jax_layer_caches(jc, tm)):
        for name in ref:
            _close(got[name], ref[name], MODEL_TOL)


@pytest.mark.parametrize("n_layers", N_LAYERS)
def test_generate_gives_the_greedy_tokens_of_jax(n_layers, env):
    jm, jp, tm, tp = _pair(n_layers, seed=3)
    toks = RNG.integers(0, tm.cfg.vocab_size, (2, 16)).astype(np.int32)
    want = jax_generate(jm, jp, {"tokens": jnp.asarray(toks)}, env,
                        steps=8, cache_len=24)
    got = serve.generate(tm, tm.cast_params(tp), {"tokens": _t(toks)},
                         steps=8, cache_len=24)
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_cache_matches_jax_and_decodes_from_it(env):
    jm, jp, tm, tp = _pair(7, seed=5)
    jc = jm.init_cache(2, 8)
    tc = tm.init_cache(2, 8, "cpu")
    for got, ref in zip(tc, _jax_layer_caches(jc, tm)):
        assert sorted(got) == sorted(ref)
        for name in ref:
            assert tuple(got[name].shape) == ref[name].shape
            np.testing.assert_array_equal(got[name].numpy(), ref[name])
    toks = RNG.integers(0, tm.cfg.vocab_size, (2, 3)).astype(np.int32)
    for i in range(3):
        with set_env(env):
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                                    jnp.asarray(i, jnp.int32), env)
        tl, tc = tm.decode_step(tp, tc, _t(toks[:, i:i + 1]), i)
        _close(tl, jl, MODEL_TOL)


@pytest.mark.parametrize("arch", [ARCH, "qwen3-1.7b"])
def test_cast_params_gives_every_leaf_the_jax_dtype(arch):
    """In bf16 JAX casts every float32 leaf that is >= 2-D in its layout:
    ``r_mat`` and ``b_zifo``, and, since the layers of the pattern groups
    are stacked on a leading axis, their 1-D leaves too (``b_if``, norm
    scales); the unrolled tail's and the top level's 1-D leaves stay
    float32."""
    n_layers = 7 if arch == ARCH else 3
    jcfg = dataclasses.replace(JAX_ARCHS[arch].reduced(), n_layers=n_layers,
                               dtype="bfloat16")
    tcfg = dataclasses.replace(get_arch(arch).reduced(), n_layers=n_layers,
                               dtype="bfloat16")
    jm = jmodel.build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    is_bf16 = jax.tree.map(
        lambda x: np.full(x.shape, x.dtype == jnp.bfloat16, np.float32),
        jmodel.cast_params(jp, jnp.bfloat16))
    want = params_from_jax(tcfg, is_bf16)
    tm = build_model(tcfg)
    got = tm.cast_params(params_from_jax(tcfg, jax.tree.map(np.asarray, jp)))
    seen = set()

    def walk(g, w, path):
        if isinstance(g, dict):
            assert sorted(g) == sorted(w), path
            for k in g:
                walk(g[k], w[k], path + (k,))
        elif isinstance(g, list):
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, path + (i,))
        else:
            bf = bool(w.flatten()[0]) if w.numel() else False
            assert g.dtype == (torch.bfloat16 if bf else torch.float32), path
            seen.add((path[-1], g.dtype))
    walk(got, want, ())
    assert ("scale", torch.bfloat16) in seen and \
        ("scale", torch.float32) in seen
    if arch == ARCH:
        assert {("r_mat", torch.bfloat16), ("b_zifo", torch.bfloat16),
                ("b_if", torch.bfloat16), ("b_if", torch.float32)} <= seen
    # the bf16 model runs (an xLSTM: bf16 R through the scan, f32 states)
    lg, caches = tm.prefill(got, {"tokens": torch.zeros((1, 8),
                                                        dtype=torch.int32)})
    assert lg.dtype == torch.float32 and bool(torch.isfinite(lg).all())
    if arch == ARCH:
        assert caches[2]["h"].dtype == torch.float32


def test_prefill_decode_consistency():
    """decode_step(prefill(t[:S])) logits == prefill(t[:S+1]) logits, the
    JAX package's own check (``test_arch_smoke.py``) at its 2e-3."""
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg)
    params = model.cast_params(model.init(torch.Generator().manual_seed(1)))
    b, s = 2, 24
    full = make_batch(cfg, b, s + 1, seed=1, cursor=0)["tokens"]
    lg, caches = model.prefill(params, {"tokens": full[:, :s]},
                               cache_len=s + 4)
    lg_dec, _ = model.decode_step(params, caches, full[:, s:s + 1], s)
    lg_full, _ = model.prefill(params, {"tokens": full})
    _close(lg_dec[:, 0], lg_full[:, 0], 2e-3)
    assert torch.isfinite(lg).all()


def test_init_has_the_jax_shapes_and_distributions():
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), n_layers=7)
    jp = jmodel.build_model(dataclasses.replace(
        JAX_ARCHS[ARCH].reduced(), n_layers=7)).init(jax.random.PRNGKey(0))
    ref = params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    got = build_model(cfg).init(torch.Generator().manual_seed(0))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (tuple(t.shape), t.dtype)
    assert shapes(got) == shapes(ref)
    h = cfg.n_heads
    m, s = got["layers"][0], got["layers"][2]
    assert torch.equal(m["b_if"], torch.tensor([0.0] * h + [3.0] * h))
    hd = cfg.d_model // h
    r = torch.cat([layer["r_mat"].flatten() for layer in got["layers"]
                   if "r_mat" in layer])
    assert abs(float(r.std()) * hd ** 0.5 - 1.0) < 0.1
    assert float(s["b_zifo"].abs().sum()) == 0.0


def test_serve_main_runs_xlstm_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert "xlstm-1.3b-reduced on cpu: generated (2, 4)" in out
