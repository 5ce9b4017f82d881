"""The ragged merge by pointer table on the CPU route.

``merge_topics_parts_segments`` takes R separate (K, V) parts grouped
into segments; on CPU tensors it runs the plain per-segment merge, held
here to ``merge_topics_segments_ref`` over the stack of the same parts.
``DeviceBackend(device="cpu").merge_many`` goes through it and is held
to the host merges (``merge_vb`` / ``merge_gs``) of each part list.
"""
import numpy as np
import pytest
import torch

from repro_torch.api.backend import DeviceBackend, HostBackend
from repro_torch.configs.lda_default import LDAConfig
from repro_torch.core.lda import MaterializedModel, topics_from_gs, \
    topics_from_vb
from repro_torch.core.merge import merge_gs, merge_vb
from repro_torch.core.plans import Interval
from repro_torch.kernels.merge_topics import ops
from repro_torch.kernels.merge_topics.ref import merge_topics_segments_ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _parts(seed, n, k, v):
    gen = torch.Generator().manual_seed(seed)
    return list(torch.rand((n, k, v), generator=gen) * 5.0)


@pytest.mark.parametrize("counts", [[1, 3, 8, 2], [129, 1, 2], [5]])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("bias,base", [(0.05, 0.05), (0.0, 0.0)])
def test_segments_by_pointer_table_match_the_stacked_reference(
        counts, weighted, bias, base):
    k, v = (6, 40) if sum(counts) > 128 else (12, 130)
    parts = _parts(sum(counts) + k, sum(counts), k, v)
    w = torch.rand(sum(counts), generator=torch.Generator().manual_seed(3)) \
        + 0.5 if weighted else torch.ones(sum(counts))
    got = ops.merge_topics_parts_segments(
        parts, counts, w if weighted else None, bias=bias, base=base)
    assert got.shape == (len(counts), k, v) and got.dtype == torch.float32
    want = merge_topics_segments_ref(torch.stack(parts), w, counts, bias,
                                     base)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_a_table_built_ahead_is_what_the_merge_reads():
    parts = _parts(7, 5, 4, 9)
    table = ops.parts_table(parts, [2, 3], [1.0, 2.0, 1.0, 1.0, 0.5])
    assert table.blob is None and table.counts == (2, 3)
    got = ops.merge_topics_parts_segments(parts, [2, 3], table=table)
    want = ops.merge_topics_parts_segments(
        parts, [2, 3], [1.0, 2.0, 1.0, 1.0, 0.5])
    assert torch.equal(got, want)


def test_segments_refuse_what_they_do_not_take():
    parts = _parts(1, 4, 3, 5)
    for counts in ([1, 2], [4, 0], []):
        with pytest.raises(ValueError):
            ops.merge_topics_parts_segments(parts, counts)
    with pytest.raises(ValueError):
        ops.merge_topics_parts_segments(parts, [4], [1.0] * 3)
    with pytest.raises(ValueError):
        ops.merge_topics_parts_segments(parts[:3] + [torch.ones(3, 4)], [4])
    table = ops.parts_table(parts, [2, 2])
    with pytest.raises(ValueError):
        ops.merge_topics_parts_segments(parts, [1, 3], table=table)
    with pytest.raises(ValueError):
        ops.merge_topics_parts_segments(parts[::-1], [2, 2], table=table)
    with pytest.raises(ValueError):
        ops.merge_topics_parts_segments(parts, [2, 2], [1.0] * 4,
                                        table=table)


def test_cpu_segments_count_no_kernel_launch():
    before = ops.merge_topics_ragged_launches
    ops.merge_topics_parts_segments(_parts(2, 3, 2, 4), [1, 2])
    assert ops.merge_topics_ragged_launches == before


CFG = LDAConfig(n_topics=6, vocab_size=40, eta=0.05)


def _model(i, kind, rng):
    stat = rng.gamma(1.0, 3.0, (CFG.n_topics, CFG.vocab_size))
    key = "lam" if kind == "vb" else "delta_nkv"
    if kind == "vb":
        stat = stat + CFG.eta
    return MaterializedModel(i, Interval(i, i + 1), 10, 100, kind,
                             {key: stat.astype(np.float32)})


@pytest.mark.parametrize("kind", ["vb", "gs"])
def test_device_backend_merge_many_matches_the_host_merges(kind):
    """Groups of 1, 3, 8 and 2 parts, some models shared between groups:
    one launch, every part counted, no stacked copy, and each answer the
    host merge of its own parts."""
    rng = np.random.default_rng(11)
    models = [_model(i, kind, rng) for i in range(10)]
    lists = [models[:1], models[2:5], models[1:9], [models[9], models[0]]]
    backend = DeviceBackend(capacity=16, device="cpu")
    got = backend.merge_many(lists, kind, CFG)
    for parts, beta in zip(lists, got):
        want = topics_from_vb(merge_vb(parts, CFG)) if kind == "vb" \
            else topics_from_gs(merge_gs(parts, CFG), CFG.eta)
        np.testing.assert_allclose(beta, want, **TOL)
    host = HostBackend().merge_many(lists, kind, CFG)
    for a, b in zip(got, host):
        np.testing.assert_allclose(a, b, **TOL)
    st = backend.stats
    assert (st.merges, st.merge_parts, st.device_launches) == (4, 14, 1)
    assert (st.pad_rows, st.host_fallbacks) == (0, 0)
    assert st.cache_misses == 10 and st.cache_hits == 4
