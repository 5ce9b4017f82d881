"""The port's LM serving path against the JAX package's, on the CPU.

For the reduced float32 configs of the dense archs, the JAX model's
weights are carried over with ``params_from_jax``; both packages then get
the same numpy tokens, and prefill logits and caches, eight decode steps'
logits and the greedy tokens of ``generate`` must agree.  The port is
also held to JAX's own prefill/decode consistency check
(``tests/test_arch_smoke.py``) with its own weights.
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
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.data.lm import make_batch  # noqa: E402
from repro_torch.kernels.common import DeviceUnavailableError  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

DENSE = ["qwen3-1.7b", "smollm-360m", "gemma-2b", "qwen2.5-14b"]
TOL = 1e-4          # float32, the port's order of sums against XLA's
RNG = np.random.default_rng(17)


@pytest.fixture(scope="module")
def env():
    return single_device_env(profile="serve")


def _pair(arch, seed=0):
    """(jax model, jax params, port model, port params) with one set of
    weights."""
    cfg = JAX_ARCHS[arch].reduced()
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tcfg = get_arch(arch).reduced()
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    return jm, jp, build_model(tcfg), tp


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def test_configs_are_copies_of_the_jax_registry():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JAX_ARCHS[name])
        assert dataclasses.asdict(cfg.reduced()) == \
            dataclasses.asdict(JAX_ARCHS[name].reduced())
        assert cfg.padded_vocab == JAX_ARCHS[name].padded_vocab
    q = get_arch("qwen3-1.7b")
    assert (q.n_layers, q.d_model, q.n_heads, q.n_kv_heads, q.hd, q.d_ff,
            q.padded_vocab) == (28, 2048, 16, 8, 128, 6144, 152064)


def test_layers_match_jax():
    x = RNG.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = RNG.normal(size=16).astype(np.float32) * 0.1
    bias = RNG.normal(size=16).astype(np.float32) * 0.1
    tx = torch.from_numpy(x)
    _close(tlayers.rmsnorm(tx, torch.from_numpy(scale), 1e-6),
           jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-6), 1e-6)
    _close(tlayers.layernorm(tx, torch.from_numpy(scale),
                             torch.from_numpy(bias), 1e-6),
           jlayers.layernorm(jnp.asarray(x), jnp.asarray(scale),
                             jnp.asarray(bias), 1e-6), 1e-5)
    pos = np.arange(100, 105)
    _close(tlayers.apply_rope(tx, torch.from_numpy(pos), 1e6),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-5)
    cfg = get_arch("gemma-2b").reduced()            # GeGLU: tanh GELU
    p = {k: RNG.normal(size=s).astype(np.float32) * 0.3 for k, s in
         (("w_gate", (16, 8)), ("w_up", (16, 8)), ("w_down", (8, 16)))}
    _close(tlayers.mlp_apply(cfg, {k: torch.from_numpy(v)
                                   for k, v in p.items()}, tx),
           jlayers.mlp_apply(JAX_ARCHS["gemma-2b"].reduced(),
                             {k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x)), 1e-5)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch, env):
    jm, jp, tm, tp = _pair(arch)
    b, s, cache_len, steps = 2, 24, 40, 8
    toks = RNG.integers(0, tm.cfg.vocab_size, (b, s + steps)).astype(np.int32)
    with set_env(env):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, env,
                            cache_len=cache_len)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])},
                        cache_len=cache_len)
    assert tl.shape == (b, 1, tm.cfg.padded_vocab) and tl.dtype == torch.float32
    _close(tl, jl)
    for name in ("k", "v"):
        stacked = np.asarray(jc["stack"]["0_attn"][name])
        assert stacked.shape[0] == len(tc)
        for i, c in enumerate(tc):
            _close(c[name], stacked[i])
    for i in range(steps):
        tok = toks[:, s + i:s + i + 1]
        with set_env(env):
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(s + i, jnp.int32), env)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), s + i)
        _close(tl, jl)


@pytest.mark.parametrize("arch", DENSE)
def test_generate_gives_the_greedy_tokens_of_jax(arch, env):
    jm, jp, tm, tp = _pair(arch, seed=3)
    toks = RNG.integers(0, tm.cfg.vocab_size, (2, 16)).astype(np.int32)
    want = jax_generate(jm, jp, {"tokens": jnp.asarray(toks)}, env,
                        steps=8, cache_len=24)
    got = serve.generate(tm, tm.cast_params(tp),
                         {"tokens": torch.from_numpy(toks)}, steps=8,
                         cache_len=24)
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_from_an_empty_cache_matches_jax(env):
    """``init_cache`` then three ``decode_step``s from position 0 (no
    prefill) give JAX's logits and caches."""
    jm, jp, tm, tp = _pair("qwen3-1.7b", seed=5)
    toks = RNG.integers(0, tm.cfg.vocab_size, (2, 3)).astype(np.int32)
    jc = jm.init_cache(2, 8)
    tc = tm.init_cache(2, 8, "cpu")
    assert len(tc) == tm.cfg.n_layers
    assert tc[0]["k"].shape == jc["stack"]["0_attn"]["k"].shape[1:]
    for i in range(3):
        with set_env(env):
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                                    jnp.asarray(i, jnp.int32), env)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]),
                                i)
        _close(tl, jl)
    _close(tc[1]["v"], np.asarray(jc["stack"]["0_attn"]["v"])[1])


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_consistency(arch):
    """decode_step(prefill(t[:S])) logits == prefill(t[:S+1]) logits, the
    JAX package's own check (``test_arch_smoke.py``) at its 2e-3."""
    cfg = get_arch(arch).reduced()
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
    cfg = get_arch("qwen2.5-14b").reduced()        # untied, qkv bias
    jp = jax_build_model(JAX_ARCHS["qwen2.5-14b"].reduced()).init(
        jax.random.PRNGKey(0))
    ref = params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    got = build_model(cfg).init(torch.Generator().manual_seed(0))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (tuple(t.shape), t.dtype)
    assert shapes(got) == shapes(ref)
    d, qd = cfg.d_model, cfg.q_dim
    assert abs(float(got["embed"].std()) - 0.02) < 0.002
    layer = got["layers"][0]
    assert abs(float(layer["attn"]["wq"].std()) * d ** 0.5 - 1.0) < 0.1
    assert abs(float(layer["attn"]["wo"].std()) * qd ** 0.5 - 1.0) < 0.1
    assert float(layer["norm1"]["scale"].abs().sum()) == 0.0
    assert float(layer["attn"]["bq"].abs().sum()) == 0.0


def test_cast_params_casts_only_matrices_once():
    """The leaves that are matrices in JAX's layout: there the layers are
    stacked, so a layer's qk-norm scale is (n_layers, hd) and is cast; the
    top-level ``final_norm`` stays float32."""
    model = build_model(get_arch("qwen3-1.7b").reduced())
    bf = dataclasses.replace(model.cfg, dtype="bfloat16")
    m = build_model(bf)
    p = m.cast_params(model.init(torch.Generator().manual_seed(0)))
    assert p["embed"].dtype == torch.bfloat16
    assert p["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert p["layers"][0]["attn"]["q_norm"].dtype == torch.bfloat16
    assert p["final_norm"]["scale"].dtype == torch.float32
    logits, caches = m.prefill(p, {"tokens": torch.zeros((1, 8),
                                                         dtype=torch.int32)})
    assert logits.dtype == torch.float32 and caches[0]["k"].dtype == \
        torch.bfloat16


MOE = ["llama4-scout-17b-a16e", "qwen3-moe-235b-a22b"]


@pytest.mark.parametrize("arch", MOE)
def test_build_model_refuses_the_unported_families(arch):
    """No family is left unported: the MoE archs, the last ones refused,
    build; only a block kind outside ``PORTED_KINDS`` is refused."""
    cfg = get_arch(arch)
    assert build_model(cfg).cfg == cfg
    with pytest.raises(NotImplementedError, match=r"block kinds \['x'\]"):
        build_model(dataclasses.replace(cfg, block_pattern=("attn", "x")))


@pytest.mark.parametrize("arch", sorted(set(ARCHS) - set(DENSE) - set(MOE)
                                        - {"xlstm-1.3b"}))
def test_build_model_takes_the_other_families(arch):
    """The other families: the hybrid, the VLM and the
    encoder–decoder."""
    cfg = get_arch(arch)
    assert build_model(cfg).cfg == cfg


def test_make_batch_is_a_function_of_seed_and_cursor():
    cfg = get_arch("qwen3-1.7b")
    a = make_batch(cfg, 3, 10, seed=0, cursor=0)
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (3, 10)
    assert int(a["tokens"].min()) >= 0 and \
        int(a["tokens"].max()) < cfg.vocab_size
    assert torch.equal(a["tokens"], make_batch(cfg, 3, 10, 0, 0)["tokens"])
    assert not torch.equal(a["tokens"], make_batch(cfg, 3, 10, 0, 1)["tokens"])
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert bool((a["labels"][:, -1] == 0).all())


def test_serve_main_runs_on_the_cpu(capsys):
    for arch in ("qwen3-1.7b", "qwen3-moe-235b-a22b"):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
        out = capsys.readouterr().out
        assert f"{arch}-reduced on cpu: generated (2, 4)" in out


def test_serve_main_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(DeviceUnavailableError):
        serve.main(["--arch", "qwen3-1.7b", "--reduced"])
