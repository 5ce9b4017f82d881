"""VB E-step and ``vb_fit`` of the PyTorch port against the JAX package.

Inputs are made from a NumPy seed and fed to both packages.  The JAX
E-step runs its Pallas kernel in interpret mode and its jnp reference;
the port's wrapper runs its plain version on CPU tensors (the kernel's
arithmetic, including the series digamma).  Tolerance 2e-4, as the JAX
package's own E-step test uses.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.vb import vb_estep as jax_core_estep  # noqa: E402
from repro.core.vb import vb_fit as jax_vb_fit  # noqa: E402
from repro.data.corpus import doc_term_matrix  # noqa: E402
from repro.kernels.vb_estep.ops import vb_estep as jax_kernel_estep  # noqa: E402
from repro.kernels.vb_estep.ref import vb_estep_ref as jax_ref  # noqa: E402
from repro_torch.configs.lda_default import LDAConfig as TorchCfg  # noqa: E402
from repro_torch.core import vb as tvb  # noqa: E402
from repro_torch.kernels.vb_estep import ops  # noqa: E402
from repro_torch.kernels.vb_estep.ref import digamma_series  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
RNG = np.random.default_rng(42)


def _inputs(d, v, k):
    x = RNG.poisson(0.5, (d, v)).astype(np.float32)
    eeb = RNG.gamma(1.0, 1.0, (k, v)).astype(np.float32)
    eeb = (eeb / eeb.sum(1, keepdims=True)).astype(np.float32)
    g0 = np.ones((d, k), np.float32)
    return x, eeb, g0


@pytest.mark.parametrize("d,v,k", [(32, 128, 16), (65, 200, 100),
                                   (128, 384, 128), (8, 64, 10),
                                   # D not a multiple of the doc block:
                                   # a ragged last block must add nothing
                                   (135, 150, 6), (300, 192, 12)])
def test_vb_estep_matches_jax(d, v, k):
    x, eeb, g0 = _inputs(d, v, k)
    g, s = ops.vb_estep(torch.from_numpy(x), torch.from_numpy(eeb),
                        torch.from_numpy(g0), 0.5, 8)
    assert g.shape == (d, k) and s.shape == (k, v)
    gk, sk = jax_kernel_estep(jnp.asarray(x), jnp.asarray(eeb),
                              jnp.asarray(g0), 0.5, 8, interpret=True)
    gr, sr = jax_ref(jnp.asarray(x), jnp.asarray(eeb), jnp.asarray(g0),
                     0.5, 8)
    for want_g, want_s in ((gk, sk), (gr, sr)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_core_vb_estep_matches_jax(use_kernel):
    x, eeb, g0 = _inputs(40, 96, 7)
    g, s = tvb.vb_estep(torch.from_numpy(x), torch.from_numpy(eeb),
                        torch.from_numpy(g0), 0.5, 8, use_kernel=use_kernel)
    gj, sj = jax_core_estep(jnp.asarray(x), jnp.asarray(eeb),
                            jnp.asarray(g0), 0.5, 8)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), **TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_core_vb_estep_refuses_tensors_off_the_cpu(use_kernel):
    """No device tensor reaches a plain version: off the CPU the plain
    path raises, and the kernel route takes only CUDA tensors."""
    x = torch.ones((4, 8), device="meta")
    with pytest.raises(ValueError):
        tvb.vb_estep(x, torch.ones((3, 8), device="meta"),
                     torch.ones((4, 3), device="meta"), 0.5, 2,
                     use_kernel=use_kernel)


def test_digamma_series_matches_library():
    x = torch.from_numpy(RNG.uniform(0.01, 50.0, 2000).astype(np.float64))
    np.testing.assert_allclose(digamma_series(x).numpy(),
                               torch.special.digamma(x).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_vb_fit_matches_jax_with_shared_lam0(small_cfg, small_corpus,
                                             use_kernel):
    """Same corpus, same λ0 (drawn by JAX from the same PRNGKey that
    JAX's vb_fit draws it from) — the whole fit agrees at 2e-4."""
    corpus, _ = small_corpus
    x = doc_term_matrix(corpus, 0, 120)
    key = jax.random.PRNGKey(3)
    lam0 = np.asarray(jax.random.gamma(
        key, 100.0, (small_cfg.n_topics, small_cfg.vocab_size),
        jnp.float32) * 0.01)
    want = np.asarray(jax_vb_fit(jnp.asarray(x), key, small_cfg))
    tcfg = TorchCfg(**{f: getattr(small_cfg, f) for f in
                       small_cfg.__dataclass_fields__})
    gen = torch.Generator().manual_seed(0)
    got = tvb.vb_fit(x, gen, tcfg, use_kernel=use_kernel, lam0=lam0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_vb_fit_draws_lam0_from_the_generator(small_cfg):
    tcfg = TorchCfg(n_topics=4, vocab_size=30, max_iters=0)
    x = np.ones((5, 30), np.float32)
    a = tvb.vb_fit(x, torch.Generator().manual_seed(1), tcfg)
    b = tvb.vb_fit(x, torch.Generator().manual_seed(1), tcfg)
    c = tvb.vb_fit(x, torch.Generator().manual_seed(2), tcfg)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # Gamma(100) * 0.01 has mean 1 and standard deviation 0.1
    assert abs(float(a.mean()) - 1.0) < 0.05
    with pytest.raises(ValueError):
        tvb.vb_fit(x, torch.Generator(), tcfg, lam0=np.ones((3, 30)))


def test_cpu_tensors_never_count_a_kernel_launch():
    before = ops.launches
    x, eeb, g0 = _inputs(8, 16, 3)
    ops.vb_estep(torch.from_numpy(x), torch.from_numpy(eeb),
                 torch.from_numpy(g0), 0.5, 2)
    assert ops.launches == before
