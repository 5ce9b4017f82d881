"""``vb_fit_sharded`` of the PyTorch port: documents over the grid's data
ranks, vocabulary over its model shards.

Given the same λ0 (``lam0=``), the sharded fit is the unsharded one with
its sums split across cells, so it is held to the port's plain
``vb_fit`` at 1e-4 on grids of ``"cpu"``, even and uneven.  Without
``lam0`` it draws λ0 as ``vb_fit`` does from the same generator state.
The data-axis merge is the JAX test's identity
(``tests/test_multidevice.py``): the sstats of two document halves add
up to the whole's, here in both packages.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.vb import vb_estep as jax_vb_estep  # noqa: E402
from repro_torch.configs.lda_default import LDAConfig  # noqa: E402
from repro_torch.core.vb import (  # noqa: E402
    _exp_dirichlet_expectation,
    vb_estep,
    vb_fit,
    vb_fit_sharded,
)
from repro_torch.distributed.sharding import MeshEnv  # noqa: E402

CFG = LDAConfig(n_topics=4, vocab_size=64, max_iters=5, e_step_iters=4)
TOL = dict(rtol=1e-4, atol=1e-4)


def _x(seed=2, d=16, v=64):
    return np.random.default_rng(seed).poisson(0.4, (d, v)).astype(
        np.float32)


def _grid(data, model):
    return MeshEnv([["cpu"] * model] * data)


@pytest.mark.parametrize("grid", [(1, 1), (2, 1), (1, 4), (2, 4), (3, 5)])
def test_sharded_fit_matches_plain_fit_from_the_same_lam0(grid):
    x = _x()
    lam0 = np.random.default_rng(5).gamma(100.0, 0.01, (4, 64)).astype(
        np.float32)
    gen = torch.Generator().manual_seed(0)
    got = vb_fit_sharded(x, gen, CFG, _grid(*grid), lam0=lam0)
    want = vb_fit(x, gen, CFG, lam0=lam0)
    assert got.shape == (4, 64) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_max_iters_overrides_the_config():
    x = _x()
    lam0 = np.full((4, 64), 1.0, np.float32)
    gen = torch.Generator()
    one = vb_fit_sharded(x, gen, CFG, _grid(2, 2), max_iters=1, lam0=lam0)
    want = vb_fit(x, gen, dataclasses.replace(CFG, max_iters=1), lam0=lam0)
    np.testing.assert_allclose(one.numpy(), want.numpy(), **TOL)
    with pytest.raises(ValueError, match="lam0 must be"):
        vb_fit_sharded(x, gen, CFG, _grid(1, 2), lam0=lam0[:, :10])


def test_without_lam0_draws_what_vb_fit_draws():
    """λ0 comes from the generator in vb_fit's order, so two fits from
    the same seed start (and end) together; the fit is finite and
    positive, as the JAX test asks of its sharded fit."""
    x = _x()
    got = vb_fit_sharded(x, torch.Generator().manual_seed(3), CFG,
                         _grid(2, 4))
    want = vb_fit(x, torch.Generator().manual_seed(3), CFG)
    lam = got.numpy()
    assert lam.shape == (4, 64)
    assert np.isfinite(lam).all() and (lam > 0).all()
    np.testing.assert_allclose(lam, want.numpy(), **TOL)


def test_data_axis_merge_is_the_sum_of_partition_sstats():
    """DP merge of sufficient statistics == Alg. 1 merge: two halves'
    sstats add up to the whole's, in the port and in the JAX package."""
    x = _x()
    rng = np.random.default_rng(2)
    lam0 = rng.gamma(100.0, 0.01, (4, 64)).astype(np.float32)
    eeb = _exp_dirichlet_expectation(torch.from_numpy(lam0))
    g0 = torch.ones((8, 4))
    xt = torch.from_numpy(x)
    _, s1 = vb_estep(xt[:8], eeb, g0, CFG.alpha, 4)
    _, s2 = vb_estep(xt[8:], eeb, g0, CFG.alpha, 4)
    _, s_all = vb_estep(xt, eeb, torch.ones((16, 4)), CFG.alpha, 4)
    np.testing.assert_allclose((s1 + s2).numpy(), s_all.numpy(), **TOL)
    _, j_all = jax_vb_estep(jnp.asarray(x), jnp.asarray(eeb.numpy()),
                            jnp.ones((16, 4), jnp.float32), CFG.alpha, 4)
    np.testing.assert_allclose(s_all.numpy(), np.asarray(j_all), **TOL)
