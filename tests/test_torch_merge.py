"""Merge wrappers of the PyTorch port against the JAX package.

The same NumPy inputs (made from a seed) go through the JAX merge
(Pallas in interpret mode, and its jnp ``merge_topics_ref``) and the
port's wrapper on CPU tensors, which runs the plain PyTorch version.
Tolerance 1e-5, as the JAX package's own merge tests use.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.lda import MaterializedModel as JaxModel  # noqa: E402
from repro.core.merge import merge_gs, merge_vb  # noqa: E402
from repro.configs.lda_default import LDAConfig  # noqa: E402
from repro.core.plans import Interval  # noqa: E402
from repro.kernels.merge_topics import ops as jax_ops  # noqa: E402
from repro.kernels.merge_topics.ref import merge_topics_ref  # noqa: E402
from repro_torch.kernels.merge_topics import ops  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(42)


@pytest.mark.parametrize("n,k,v", [(1, 16, 64), (5, 100, 300), (12, 128, 512)])
def test_merge_topics_matches_jax(n, k, v):
    st = RNG.normal(size=(n, k, v)).astype(np.float32)
    w = RNG.uniform(0.2, 2.0, n).astype(np.float32)
    got = ops.merge_topics(torch.from_numpy(st), torch.from_numpy(w),
                           bias=0.05, base=0.05)
    assert got.shape == (k, v) and got.dtype == torch.float32
    pallas = jax_ops.merge_topics(jnp.asarray(st), jnp.asarray(w),
                                  bias=0.05, base=0.05, interpret=True)
    ref = merge_topics_ref(jnp.asarray(st), jnp.asarray(w), 0.05, 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _batch(counts, k, v):
    stats = [RNG.gamma(1.0, 1.0, (n, k, v)).astype(np.float32)
             for n in counts]
    weights = [RNG.uniform(0.2, 2.0, n).astype(np.float32) for n in counts]
    return stats, weights


@pytest.mark.parametrize("counts", [
    [1],                  # n' = 1: single row, single segment
    [1, 1, 1],            # all-equal width 1
    [3, 3, 3],            # all-equal width > 1
    [5, 4, 3, 2, 1],      # strictly descending
    [1, 1, 1, 16],        # single wide outlier
])
@pytest.mark.parametrize("k,v", [(12, 128), (6, 150)])
@pytest.mark.parametrize("bias,base", [(0.05, 0.05), (0.0, 0.0)])
def test_ragged_matches_jax(counts, k, v, bias, base):
    stats, weights = _batch(counts, k, v)
    out, pad_rows, launches = ops.merge_topics_ragged(
        [torch.from_numpy(s) for s in stats],
        [torch.from_numpy(w) for w in weights], bias=bias, base=base)
    assert (pad_rows, launches) == (0, 1)
    assert len(out) == len(counts)
    jax_out, _, _ = jax_ops.merge_topics_ragged(
        [jnp.asarray(s) for s in stats], [jnp.asarray(w) for w in weights],
        bias=bias, base=base, interpret=True)
    for got, want, s, w in zip(out, jax_out, stats, weights):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        ref = merge_topics_ref(jnp.asarray(s), jnp.asarray(w), bias, base)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_segment_ids_match_jax():
    counts = [2, 1, 3]
    got = ops.segment_ids(counts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_ops.segment_ids(counts)))


def test_merge_segments_rejects_bad_counts():
    st = torch.zeros((3, 2, 4))
    w = torch.ones(3)
    with pytest.raises(ValueError):
        ops.merge_topics_segments(st, w, [1, 1])
    with pytest.raises(ValueError):
        ops.merge_topics_segments(st, w, [3, 0])


CFG = LDAConfig(n_topics=6, vocab_size=40, eta=0.05, decay=0.9)


def _models(key, n):
    return [JaxModel(i, Interval(i, i + 1), 10, 100, "vb" if key == "lam"
                     else "gs",
                     {key: RNG.gamma(1.0, 1.0, (CFG.n_topics, CFG.vocab_size))
                      .astype(np.float32)}) for i in range(n)]


def test_merge_vb_stats_matches_host_alg1():
    models = _models("lam", 4)
    w = np.array([1.0, 0.5, 2.0, 1.0], np.float32)
    lams = torch.from_numpy(np.stack([m.lam for m in models]))
    got = ops.merge_vb_stats(lams, torch.from_numpy(w), CFG.eta)
    np.testing.assert_allclose(got.numpy(), merge_vb(models, CFG, w), **TOL)
    jax_got = jax_ops.merge_vb_stats(jnp.asarray(lams.numpy()),
                                     jnp.asarray(w), CFG.eta,
                                     interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_got), **TOL)


def test_merge_gs_stats_matches_host_alg2():
    models = _models("delta_nkv", 3)
    staleness = np.array([0, 2, 1], np.int32)
    deltas = torch.from_numpy(np.stack([m.delta_nkv for m in models]))
    got = ops.merge_gs_stats(deltas, torch.from_numpy(staleness), CFG.decay)
    np.testing.assert_allclose(
        got.numpy(), merge_gs(models, CFG, staleness=staleness), **TOL)
    jax_got = jax_ops.merge_gs_stats(jnp.asarray(deltas.numpy()),
                                     jnp.asarray(staleness), CFG.decay,
                                     interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_got), **TOL)


def test_cpu_tensors_never_count_a_kernel_launch():
    before = (ops.merge_topics_launches, ops.merge_topics_ragged_launches)
    st = torch.ones((2, 3, 4))
    ops.merge_topics(st, torch.ones(2))
    ops.merge_topics_ragged([st, st], [torch.ones(2), torch.ones(2)])
    assert (ops.merge_topics_launches,
            ops.merge_topics_ragged_launches) == before
