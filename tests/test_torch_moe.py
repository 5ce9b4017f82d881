"""The port's Mixture-of-Experts FFN and MoE models against the JAX
package's, on the CPU.

Each case runs on the reduced qwen3-moe-235b-a22b (4 experts, top-2) and
llama4-scout-17b-a16e (top-1 and a shared expert) configs in float32:
the JAX function and the port's get the same numpy weights and inputs.
``_route`` at 1e-6 (a zero token's equal logits must take JAX's
lower-index-first order), ``moe_dispatch`` at 1e-5 (aux 1e-6) at the
reduced capacity factor, where nothing drops, and at 0.5, where pairs
drop, ``moe_decode`` at 1e-5, ``_aux_loss`` at 1e-6; then the whole
models through ``params_from_jax``: prefill logits and caches and
decode-step logits at 1e-4, the greedy tokens of ``generate``, and the
dtypes ``cast_params`` gives every MoE leaf.
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
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.models.model import cast_params as jax_cast_params  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.lm import make_batch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

try:
    from hypothesis import given, settings, strategies as hst
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - optional dependency
    HAVE_HYPOTHESIS = False

MOE = ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"]
RNG = np.random.default_rng(23)


@pytest.fixture(scope="module")
def env():
    return single_device_env(profile="serve")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _cfgs(arch, **change):
    """(JAX config, port config), reduced, with the same changes."""
    return (dataclasses.replace(JAX_ARCHS[arch].reduced(), **change),
            dataclasses.replace(get_arch(arch).reduced(), **change))


def _moe_params(jcfg, seed):
    """JAX's ``moe_init`` weights, as (JAX tree, port dict)."""
    jp = jmoe.moe_init(jcfg, jax.random.PRNGKey(seed))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _tokens(cfg, t, zero_row=None):
    x = RNG.normal(size=(t, cfg.d_model)).astype(np.float32)
    if zero_row is not None:
        x[zero_row] = 0.0
    return x


@pytest.mark.parametrize("arch", MOE)
def test_route_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _moe_params(jcfg, 0)
    x = _tokens(tcfg, 24, zero_row=5)
    k = tcfg.moe_top_k
    want = jmoe._route(jnp.asarray(x), jp["router"], k)
    got = moe._route(torch.from_numpy(x), tp["router"], k)
    for g, w in zip(got, want):
        _close(g, w, 1e-6)
    ids = got[1].numpy()
    np.testing.assert_array_equal(ids, np.asarray(want[1]))
    # the zero token's logits are all equal: JAX's order, lower index first
    np.testing.assert_array_equal(ids[5], np.arange(k))
    assert float(got[2][5].max() - got[2][5].min()) == 0.0


def test_route_takes_the_lower_index_on_ties():
    """Ties among the chosen and across the cut: equal probabilities keep
    their index order, as ``jax.lax.top_k``."""
    router = torch.zeros((2, 6))
    router[0, [1, 3, 4]] = 1.0              # experts 1, 3, 4 tie on top
    x = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    _, ids, _ = moe._route(x, router, 2)
    _, jids = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(x.numpy() @ router.numpy()), axis=-1), 2)
    np.testing.assert_array_equal(ids.numpy(), [[1, 3], [0, 1]])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("cf", [None, 0.5], ids=["no-drops", "drops"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_dispatch_matches_jax(arch, cf, env):
    change = {} if cf is None else {"capacity_factor": cf}
    jcfg, tcfg = _cfgs(arch, **change)
    jp, tp = _moe_params(jcfg, 1)
    b, s = 2, 12
    x = _tokens(tcfg, b * s, zero_row=3).reshape(b, s, tcfg.d_model)
    with set_env(env):
        jy, jaux = jmoe.moe_dispatch(jcfg, jp, jnp.asarray(x), env=env)
    y, aux = moe.moe_dispatch(tcfg, tp, torch.from_numpy(x))
    assert y.shape == (b, s, tcfg.d_model) and y.dtype == torch.float32
    _close(y, jy, 1e-5)
    _close(aux, jaux, 1e-6)
    _, ids, _ = moe._route(torch.from_numpy(x).reshape(b * s, -1),
                           tp["router"], tcfg.moe_top_k)
    pos = moe.capacity_positions(ids.reshape(-1), tcfg.n_experts)
    dropped = int((pos >= moe.capacity(tcfg, b * s)).sum())
    if cf is None:
        assert dropped == 0
    else:
        assert dropped > 0
        # a dropped pair adds nothing: the drop case differs from no drops
        y_all, _ = moe.moe_dispatch(get_arch(arch).reduced(), tp,
                                    torch.from_numpy(x))
        assert float((y_all - y).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_matches_jax(arch, env):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _moe_params(jcfg, 2)
    x = _tokens(tcfg, 3, zero_row=1).reshape(3, 1, tcfg.d_model)
    with set_env(env):
        jy = jmoe.moe_decode(jcfg, jp, jnp.asarray(x), env=env)
    y = moe.moe_decode(tcfg, tp, torch.from_numpy(x))
    assert y.shape == (3, 1, tcfg.d_model)
    _close(y, jy, 1e-5)
    # with nothing dropped, one token's decode is its dispatch
    yd, _ = moe.moe_dispatch(tcfg, tp, torch.from_numpy(x))
    _close(y, yd, 1e-5)


@pytest.mark.parametrize("arch", MOE)
def test_aux_loss_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, _ = _moe_params(jcfg, 3)
    x = _tokens(tcfg, 40)
    _, ids, probs = jmoe._route(jnp.asarray(x), jp["router"],
                                tcfg.moe_top_k)
    want = jmoe._aux_loss(probs, ids, tcfg.n_experts, ())
    got = moe._aux_loss(torch.from_numpy(np.asarray(probs)),
                        torch.from_numpy(np.asarray(ids)).long(),
                        tcfg.n_experts)
    _close(got, want, 1e-6)


def _naive_positions(ids):
    seen = {}
    out = []
    for e in ids:
        out.append(seen.get(e, 0))
        seen[e] = out[-1] + 1
    return out


if HAVE_HYPOTHESIS:
    @settings(max_examples=60, deadline=None)
    @given(n_experts=hst.integers(1, 9),
           ids=hst.lists(hst.integers(0, 8), min_size=1, max_size=200))
    def test_capacity_positions_count_each_expert_in_token_order(n_experts,
                                                                 ids):
        ids = [i % n_experts for i in ids]
        got = moe.capacity_positions(torch.tensor(ids), n_experts)
        assert got.tolist() == _naive_positions(ids)


def test_capacity_rounds_halves_to_even_as_jax():
    cfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b").reduced(),
                              n_experts=4, moe_top_k=1, capacity_factor=1.0)
    # t k / e = 18 / 4 = 4.5 and 26 / 4 = 6.5: Python's round gives 4, 6
    assert [moe.capacity(cfg, t) for t in (18, 26, 3)] == [4, 6, 4]


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def _pair(arch, seed=0):
    jcfg, tcfg = _cfgs(arch)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    return jm, jp, build_model(tcfg), tp


@pytest.mark.parametrize("arch", MOE)
def test_params_from_jax_carries_the_moe_leaves(arch):
    jm, jp, tm, tp = _pair(arch)
    stack = jax.tree.map(np.asarray, jp["stack"]["0_attn"])
    cfg = tm.cfg
    for i, layer in enumerate(tp["layers"]):
        assert set(layer["moe"]) == set(stack["moe"])
        assert layer["moe"]["expert_w_gate"].shape == \
            (cfg.n_experts, cfg.d_model, cfg.d_ff_expert)
        assert layer["moe"]["expert_w_down"].shape == \
            (cfg.n_experts, cfg.d_ff_expert, cfg.d_model)
        for name, w in layer["moe"].items():
            np.testing.assert_array_equal(w.numpy(), stack["moe"][name][i])
        assert ("shared_mlp" in layer) == bool(cfg.n_shared_experts)
        assert "mlp" not in layer
        if cfg.n_shared_experts:
            np.testing.assert_array_equal(
                layer["shared_mlp"]["w_up"].numpy(),
                stack["shared_mlp"]["w_up"][i])


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_jax(arch, env):
    jm, jp, tm, tp = _pair(arch)
    b, s, cache_len, steps = 2, 20, 32, 6
    toks = RNG.integers(0, tm.cfg.vocab_size, (b, s + steps)).astype(np.int32)
    with set_env(env):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s])}, env,
                            cache_len=cache_len)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s])},
                        cache_len=cache_len)
    assert tl.shape == (b, 1, tm.cfg.padded_vocab)
    _close(tl, jl, 1e-4)
    for name in ("k", "v"):
        stacked = np.asarray(jc["stack"]["0_attn"][name])
        assert stacked.shape[0] == len(tc)
        for i, c in enumerate(tc):
            _close(c[name], stacked[i], 1e-4)
    for i in range(steps):
        tok = toks[:, s + i:s + i + 1]
        with set_env(env):
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(s + i, jnp.int32), env)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), s + i)
        _close(tl, jl, 1e-4)


@pytest.mark.parametrize("arch", MOE)
def test_generate_gives_the_greedy_tokens_of_jax(arch, env):
    jm, jp, tm, tp = _pair(arch, seed=4)
    toks = RNG.integers(0, tm.cfg.vocab_size, (2, 16)).astype(np.int32)
    want = jax_generate(jm, jp, {"tokens": jnp.asarray(toks)}, env,
                        steps=8, cache_len=24)
    got = serve.generate(tm, tm.cast_params(tp),
                         {"tokens": torch.from_numpy(toks)}, steps=8,
                         cache_len=24)
    assert got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _dtypes(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _dtypes(v, prefix + (k,))
    else:
        yield prefix, tree.dtype


@pytest.mark.parametrize("arch", MOE)
def test_cast_params_gives_every_moe_leaf_the_jax_dtype(arch):
    """In bf16 every leaf of an MoE layer (router and experts among them)
    takes the dtype JAX's ``cast_params`` gives its stacked leaf."""
    jm, jp, tm, tp = _pair(arch)
    bf = build_model(dataclasses.replace(tm.cfg, dtype="bfloat16"))
    want = dict(_dtypes(jax_cast_params(jp, jnp.bfloat16)["stack"]["0_attn"]))
    got = bf.cast_params(tp)
    for layer in got["layers"]:
        dts = dict(_dtypes(layer))
        assert set(dts) == set(want)
        for path, dt in dts.items():
            assert str(dt).removeprefix("torch.") == str(want[path]), path
    assert got["layers"][0]["moe"]["router"].dtype == torch.bfloat16
    assert got["layers"][0]["moe"]["expert_w_down"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", MOE)
def test_init_cast_is_the_cast_of_init(arch):
    """``init(cast=True)`` casts each expert tensor as it is drawn: the
    same draws, bit for bit, as casting the float32 masters after."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="bfloat16")
    m = build_model(cfg)
    a = m.init(torch.Generator().manual_seed(7), cast=True)
    b = m.cast_params(m.init(torch.Generator().manual_seed(7)))
    for la, lb in zip(a["layers"], b["layers"]):
        da, db = dict(_dtypes(la)), dict(_dtypes(lb))
        assert da == db
        for name in la["moe"]:
            assert torch.equal(la["moe"][name], lb["moe"][name])
    assert torch.equal(a["embed"], b["embed"])


@pytest.mark.parametrize("arch", MOE)
def test_prefill_decode_consistency_where_nothing_drops(arch):
    """decode_step(prefill(t[:S])) == prefill(t[:S+1]) at 2e-3, the JAX
    package's check, at capacity_factor = E / k: no pair can drop, so the
    prefill's routing cannot depend on how many tokens share the batch
    (at a smaller factor the prefill drops and decode does not, in JAX
    as here)."""
    cfg = get_arch(arch).reduced()
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                              / cfg.moe_top_k)
    model = build_model(cfg)
    params = model.cast_params(model.init(torch.Generator().manual_seed(1)))
    b, s = 2, 24
    full = make_batch(cfg, b, s + 1, seed=1, cursor=0)["tokens"]
    _, caches = model.prefill(params, {"tokens": full[:, :s]},
                              cache_len=s + 4)
    lg_dec, _ = model.decode_step(params, caches, full[:, s:s + 1], s)
    lg_full, _ = model.prefill(params, {"tokens": full})
    _close(lg_dec[:, 0], lg_full[:, 0], 2e-3)
