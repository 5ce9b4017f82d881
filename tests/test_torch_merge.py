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


@pytest.mark.parametrize("n,k,v", [(1, 16, 64), (8, 100, 300), (129, 6, 40)])
@pytest.mark.parametrize("weights_as", ["list", "tensor"])
def test_merge_topics_parts_matches_jax(n, k, v, weights_as):
    """n separate parts (the device backend's cached tensors), weights as
    numbers or a tensor, against the JAX merge of their stack."""
    st = RNG.gamma(1.0, 1.0, (n, k, v)).astype(np.float32)
    w = RNG.uniform(0.2, 2.0, n).astype(np.float32)
    parts = [torch.from_numpy(p) for p in st]
    weights = [float(x) for x in w] if weights_as == "list" \
        else torch.from_numpy(w)
    got = ops.merge_topics_parts(parts, weights, bias=0.05, base=0.05)
    assert got.shape == (k, v) and got.dtype == torch.float32
    pallas = jax_ops.merge_topics(jnp.asarray(st), jnp.asarray(w),
                                  bias=0.05, base=0.05, interpret=True)
    ref = merge_topics_ref(jnp.asarray(st), jnp.asarray(w), 0.05, 0.05)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_merge_topics_parts_refuses_what_it_does_not_take():
    a = torch.ones((3, 4))
    with pytest.raises(ValueError):
        ops.merge_topics_parts([], [])
    with pytest.raises(ValueError):
        ops.merge_topics_parts([a, torch.ones((4, 3))], [1.0, 1.0])
    with pytest.raises(ValueError):
        ops.merge_topics_parts([a, a], [1.0])
    with pytest.raises(ValueError):
        ops.merge_topics_parts([a, a.to("meta")], [1.0, 1.0])


def _batch(counts, k, v):
    stats = [RNG.gamma(1.0, 1.0, (n, k, v)).astype(np.float32)
             for n in counts]
    weights = [RNG.uniform(0.2, 2.0, n).astype(np.float32) for n in counts]
    return stats, weights


def _parts(stats):
    """Every query's rows as separate (K, V) tensors, in query order."""
    return [p for s in stats for p in torch.from_numpy(s).unbind(0)]


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
    out = ops.merge_topics_parts_segments(
        _parts(stats), counts, np.concatenate(weights), bias=bias, base=base)
    assert out.shape == (len(counts), k, v) and out.dtype == torch.float32
    jax_out, _, _ = jax_ops.merge_topics_ragged(
        [jnp.asarray(s) for s in stats], [jnp.asarray(w) for w in weights],
        bias=bias, base=base, interpret=True)
    for got, want, s, w in zip(out, jax_out, stats, weights):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        ref = merge_topics_ref(jnp.asarray(s), jnp.asarray(w), bias, base)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("b,n,k,v", [(1, 1, 16, 64), (3, 4, 100, 300),
                                     (4, 8, 12, 128), (2, 3, 6, 150)])
def test_merge_topics_batch_matches_jax(b, n, k, v):
    st = RNG.gamma(1.0, 1.0, (b, n, k, v)).astype(np.float32)
    w = RNG.uniform(0.2, 2.0, (b, n)).astype(np.float32)
    w[0, -1] = 0.0                                    # a zero-weight pad row
    got = ops.merge_topics_batch(torch.from_numpy(st), torch.from_numpy(w),
                                 bias=0.05, base=0.05)
    assert got.shape == (b, k, v) and got.dtype == torch.float32
    pallas = jax_ops.merge_topics_batch(jnp.asarray(st), jnp.asarray(w),
                                        bias=0.05, base=0.05, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    for i in range(b):
        ref = merge_topics_ref(jnp.asarray(st[i]), jnp.asarray(w[i]),
                               0.05, 0.05)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref), **TOL)


def test_merge_topics_batch_rejects_bad_shapes():
    with pytest.raises(ValueError, match="b, n, K, V"):
        ops.merge_topics_batch(torch.zeros((2, 3, 4)), torch.ones((2, 3)))
    with pytest.raises(ValueError, match="weights"):
        ops.merge_topics_batch(torch.zeros((2, 3, 4, 5)), torch.ones(6))


@pytest.mark.parametrize("counts", [
    [1],                  # one plan: the unbatched merge
    [1, 1, 1],            # one bucket, no padding
    [3, 3, 3],
    [5, 4, 3, 2, 1],      # buckets 1, 2, 4 and 8, padded within each
    [1, 1, 1, 16],        # single wide outlier in a bucket of its own
    [2, 3, 9, 4],
])
@pytest.mark.parametrize("bias,base", [(0.05, 0.05), (0.0, 0.0)])
def test_bucketed_matches_jax(counts, bias, base):
    stats, weights = _batch(counts, 6, 150)
    out, pad_rows, launches = ops.merge_topics_bucketed(
        [torch.from_numpy(s) for s in stats],
        [torch.from_numpy(w) for w in weights], bias=bias, base=base)
    jax_out, jax_pad, jax_launches = jax_ops.merge_topics_bucketed(
        [jnp.asarray(s) for s in stats], [jnp.asarray(w) for w in weights],
        bias=bias, base=base, interpret=True)
    assert (pad_rows, launches) == (jax_pad, jax_launches)
    ragged = ops.merge_topics_parts_segments(
        _parts(stats), counts, np.concatenate(weights), bias=bias, base=base)
    assert len(out) == len(counts)
    for got, want, seg in zip(out, jax_out, ragged):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got.numpy(), seg.numpy(), **TOL)


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
    counters = ("merge_topics_launches", "merge_topics_ragged_launches",
                "merge_topics_segments_launches",
                "merge_topics_batch_launches")
    before = [getattr(ops, c) for c in counters]
    st = torch.ones((2, 3, 4))
    ops.merge_topics(st, torch.ones(2))
    ops.merge_topics_parts(list(st), [1.0, 1.0])
    ops.merge_topics_parts_segments(list(st) * 2, [1, 3])
    ops.merge_topics_segments(st, torch.ones(2), [1, 1])
    ops.merge_topics_bucketed([st, st], [torch.ones(2), torch.ones(2)])
    assert [getattr(ops, c) for c in counters] == before
