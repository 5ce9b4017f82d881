"""``vb_fit_sharded`` of the PyTorch port: documents over the grid's data
ranks, vocabulary over its model shards.

Given the same λ0 (``lam0=``), the sharded fit is the unsharded one with
its sums split across cells, so it is held to the port's plain
``vb_fit`` at 1e-4 on grids of ``"cpu"``, even and uneven.  Without
``lam0`` it draws λ0 as ``vb_fit`` does from the same generator state.
The data-axis merge is the JAX test's identity
(``tests/test_multidevice.py``): the sstats of two document halves add
up to the whole's, here in both packages.  After 10 iterations the
float32 fits part by rounding only, which the iteration amplifies: they
lie as far from a float64 fit as from each other, as far as a one-ulp
change of λ0 moves them, and within ``DRIFT_BOUND`` of the float64 fit.
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
# every float32 fit after 10 iterations lies within this of the float64
# fit: twice the largest distance measured (7.90e-5, the (2, 2) grid's;
# λ up to 10.9) at these widths
DRIFT_BOUND = 1.6e-4


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


def _vb_fit64(x, cfg, lam0):
    """``vb_fit``'s loop in float64 (the plain E-step takes any dtype)."""
    x = torch.as_tensor(x, dtype=torch.float64)
    lam = torch.as_tensor(lam0, dtype=torch.float64)
    gamma0 = torch.ones((x.shape[0], cfg.n_topics), dtype=torch.float64)
    for _ in range(cfg.max_iters):
        _, sstats = vb_estep(x, _exp_dirichlet_expectation(lam), gamma0,
                             cfg.alpha, cfg.e_step_iters)
        lam = cfg.eta + sstats
    return lam.numpy()


def test_ten_iterations_part_the_fits_by_rounding_only():
    """The (2, 2) grid's drift after 10 iterations is rounding, not a
    fault: from one λ0, ``vb_fit`` in float64, and ``vb_fit`` and
    ``vb_fit_sharded`` on (1, 1) and (2, 2) grids in float32.  Each
    float32 fit lies within 3x as far from the float64 fit as the float32
    fits lie from each other (a fault in the sharded fit would put it
    alone far off); moving each entry of λ0 to a neighbouring float32
    (one ulp) moves the unsharded fit as far as the grid does (within 3x:
    the iteration amplifies rounding that much); every fit stays within
    ``DRIFT_BOUND`` of the float64 fit."""
    x = _x()
    lam0 = np.random.default_rng(5).gamma(100.0, 0.01, (4, 64)).astype(
        np.float32)
    cfg = dataclasses.replace(CFG, max_iters=10)
    gen = torch.Generator()
    want = _vb_fit64(x, cfg, lam0)
    fits = {"vb_fit": vb_fit(x, gen, cfg, lam0=lam0).numpy()}
    for grid in ((1, 1), (2, 2)):
        fits[grid] = vb_fit_sharded(x, gen, cfg, _grid(*grid),
                                    lam0=lam0).numpy()
    to64 = {name: float(np.abs(f - want).max()) for name, f in fits.items()}
    spread = max(float(np.abs(a - b).max()) for a in fits.values()
                 for b in fits.values())
    for name, dist in to64.items():
        assert spread / 3 <= dist <= 3 * spread, (name, dist, spread)
    moved = []
    for seed in range(3):
        sign = np.random.default_rng(seed).choice([-1.0, 1.0], lam0.shape)
        nudged = (lam0 * (1 + sign * 2.0 ** -24)).astype(np.float32)
        assert (nudged != lam0).all()
        moved.append(float(np.abs(vb_fit(x, gen, cfg, lam0=nudged).numpy()
                                  - fits["vb_fit"]).max()))
    grid_drift = float(np.abs(fits[(2, 2)] - fits["vb_fit"]).max())
    assert max(moved) / 3 <= grid_drift <= 3 * max(moved), (grid_drift,
                                                            moved)
    assert max(to64.values()) <= DRIFT_BOUND, to64
