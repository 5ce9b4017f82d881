"""The port's VLM serving path (llava-next: precomputed patch embeddings
spliced over the first positions of a dense stack) against the JAX
package's, on the CPU.

The reduced float32 config (``cfg.reduced()``: 4 patch positions, hd 16)
with the JAX weights carried over by ``params_from_jax``; both packages
get the same numpy tokens and patch embeddings, drawn from a seed.
Tolerances: 1e-4 for the float32 model (the port's order of sums against
XLA's), 2e-3 for the prefill/decode consistency check
(``tests/test_arch_smoke.py``'s).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.data.lm import make_batch as jax_make_batch  # noqa: E402
from repro.distributed.sharding import set_env, single_device_env  # noqa: E402
from repro.launch.serve import generate as jax_generate  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.lm import make_batch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ARCH = "llava-next-34b"
TOL = 1e-4
RNG = np.random.default_rng(37)


@pytest.fixture(scope="module")
def env():
    return single_device_env(profile="serve")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _pair(seed=0):
    jm = jax_build_model(JAX_ARCHS[ARCH].reduced())
    jp = jm.init(jax.random.PRNGKey(seed))
    tcfg = get_arch(ARCH).reduced()
    return jm, jp, build_model(tcfg), params_from_jax(
        tcfg, jax.tree.map(np.asarray, jp))


def _inputs(cfg, b, s):
    toks = RNG.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    pe = (RNG.normal(size=(b, min(cfg.n_patches, s), cfg.d_model))
          * 0.02).astype(np.float32)
    return toks, pe


def test_make_batch_carries_the_patch_stub():
    """JAX's stub: ``patch_embeds`` (B, min(n_patches, S), d) N(0, 0.02²)
    whose positions carry no target (label -1), from the batch's own
    seeded stream; the JAX batch has the same keys, shapes and labels."""
    cfg = get_arch(ARCH)
    a = make_batch(cfg, 2, 3000, seed=0, cursor=0)
    assert sorted(a) == ["labels", "patch_embeds", "tokens"]
    assert a["patch_embeds"].shape == (2, 2880, cfg.d_model)
    assert a["patch_embeds"].dtype == torch.float32
    assert abs(float(a["patch_embeds"].std()) - 0.02) < 0.001
    assert bool((a["labels"][:, :2880] == -1).all())
    assert torch.equal(a["labels"][:, 2880:-1], a["tokens"][:, 2881:])
    b = make_batch(cfg, 2, 3000, seed=0, cursor=0)
    assert torch.equal(a["patch_embeds"], b["patch_embeds"])
    assert not torch.equal(a["patch_embeds"],
                           make_batch(cfg, 2, 3000, 0, 1)["patch_embeds"])
    rc = get_arch(ARCH).reduced()
    short = make_batch(rc, 2, 3, seed=0, cursor=0)       # S < n_patches
    want = jax_make_batch(JAX_ARCHS[ARCH].reduced(), 2, 3, 0, 0)
    assert sorted(short) == sorted(want)
    for k in short:
        assert tuple(short[k].shape) == want[k].shape
    np.testing.assert_array_equal(short["labels"].numpy(),
                                  np.full((2, 3), -1))


@pytest.mark.parametrize("s", [12, 3])
def test_prefill_and_decode_match_jax(s, env):
    """A prompt longer than the 4 patch positions, and one shorter (the
    patches cover it)."""
    jm, jp, tm, tp = _pair()
    b, cache_len, steps = 2, s + 8, 8
    toks, pe = _inputs(tm.cfg, b, s + steps)
    pe = pe[:, :min(tm.cfg.n_patches, s)]
    with set_env(env):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :s]),
                                 "patch_embeds": jnp.asarray(pe)}, env,
                            cache_len=cache_len)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :s]),
                             "patch_embeds": torch.from_numpy(pe)},
                        cache_len=cache_len)
    assert tl.shape == (b, 1, tm.cfg.padded_vocab)
    _close(tl, jl)
    for name in ("k", "v"):
        stacked = np.asarray(jc["stack"]["0_attn"][name])
        for i, c in enumerate(tc):
            _close(c[name], stacked[i])
    for i in range(steps):
        tok = toks[:, s + i:s + i + 1]
        with set_env(env):
            jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(s + i, jnp.int32), env)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), s + i)
        _close(tl, jl)


def test_the_patches_reach_the_logits():
    """Other patch embeddings give other logits; other tokens under the
    patch positions give the same ones."""
    _, _, tm, tp = _pair(seed=1)
    toks, pe = _inputs(tm.cfg, 2, 10)
    base = {"tokens": torch.from_numpy(toks),
            "patch_embeds": torch.from_numpy(pe)}
    lg, _ = tm.prefill(tp, base)
    lg2, _ = tm.prefill(tp, {**base, "patch_embeds": base["patch_embeds"]
                             + 0.05})
    assert float((lg - lg2).abs().max()) > 1e-3
    other = base["tokens"].clone()
    other[:, :tm.cfg.n_patches] = (other[:, :tm.cfg.n_patches] + 1) % 256
    lg3, _ = tm.prefill(tp, {**base, "tokens": other})
    assert torch.equal(lg, lg3)


def test_generate_gives_the_greedy_tokens_of_jax(env):
    jm, jp, tm, tp = _pair(seed=3)
    toks, pe = _inputs(tm.cfg, 2, 16)
    want = jax_generate(jm, jp, {"tokens": jnp.asarray(toks),
                                 "patch_embeds": jnp.asarray(pe)}, env,
                        steps=8, cache_len=24)
    got = serve.generate(tm, tm.cast_params(tp),
                         {"tokens": torch.from_numpy(toks),
                          "patch_embeds": torch.from_numpy(pe)},
                         steps=8, cache_len=24)
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_decode_consistency():
    """decode_step(prefill(t[:S])) logits == prefill(t[:S+1]) logits with
    the patches spliced in both, at the JAX package's 2e-3."""
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg)
    params = model.cast_params(model.init(torch.Generator().manual_seed(1)))
    batch = make_batch(cfg, 2, 25, seed=1, cursor=0)
    full, pe = batch["tokens"], batch["patch_embeds"]
    lg, caches = model.prefill(params, {"tokens": full[:, :24],
                                        "patch_embeds": pe}, cache_len=28)
    lg_dec, _ = model.decode_step(params, caches, full[:, 24:], 24)
    lg_full, _ = model.prefill(params, {"tokens": full, "patch_embeds": pe})
    _close(lg_dec[:, 0], lg_full[:, 0], 2e-3)
    assert torch.isfinite(lg).all()


def test_serve_main_runs_the_vlm_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert "llava-next-34b-reduced on cpu: generated (2, 4)" in out
