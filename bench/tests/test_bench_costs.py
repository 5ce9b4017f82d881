"""The frozen work counts against counts worked by hand."""
import numpy as np
import pytest

from bench.costs import kernels as costs


def test_merge_counts_by_hand():
    # 3 parts of (2, 5): 30 elements read, 3 weights, 10 written; 3 ops each
    w = costs.merge(3, 2, 5)
    assert (w.n_bytes, w.n_ops) == (4 * (30 + 3 + 10), 90)


def test_merge_segments_counts_by_hand():
    # segments of 1, 3, 2 parts of (2, 5): 60 read, 6 weights, 4 offsets,
    # 3 results of 10
    w = costs.merge_segments([1, 3, 2], 2, 5)
    assert (w.n_bytes, w.n_ops) == (4 * (60 + 6 + 4 + 30), 180)


def test_vb_estep_counts_by_hand():
    # D=2, K=3, V=4, nnz=5, 2 iterations: CSR and its indexes 4 * 5 + 3 + 5,
    # eeb 12 in, gamma0 6 in, gamma 6 out, sstats 12 out
    w = costs.vb_estep(2, 3, 4, 5, 2)
    assert w.n_bytes == 4 * (20 + 3 + 5 + 12 + 12 + 12)
    assert w.n_ops == 3 * (4 * 3 * 5 + 5 + 62 * 2 * 3) + 12


def test_gibbs_sweep_counts_by_hand():
    # 7 tokens of 2 documents, K=3, V=4: 5 words of 4 bytes a token, the
    # documents' counts in and out, the snapshot in and the counts out,
    # its row sums; 8 operations a topic a token
    w = costs.gibbs_sweep(7, 2, 3, 4)
    assert w.n_bytes == 4 * (35 + 12 + 24 + 3)
    assert w.n_ops == 8 * 3 * 7


def test_least_time_takes_the_larger_bound():
    w = costs.Work(costs.PEAK_BYTES_S, 0.5 * costs.PEAK_F32_FLOPS)
    assert w.least_s() == pytest.approx(1.0)
    w = costs.Work(0.5 * costs.PEAK_BYTES_S, 2 * costs.PEAK_F32_FLOPS)
    assert w.least_s() == pytest.approx(2.0)


@pytest.mark.parametrize("block_docs", [1, 3, 64])
def test_gibbs_count_ignores_the_block_size(block_docs):
    """The port's own count grows with its blocked layout's padding; the
    frozen count is the gap's real tokens whatever block size the port
    picks."""
    from repro_torch.core.gibbs import blocked_layout
    from repro_torch.kernels.gibbs_sweep.ops import cost as port_cost

    lengths = np.array([5, 1, 9, 2, 7])
    doc_ids = np.repeat(np.arange(5), lengths).astype(np.int32)
    tokens = np.arange(len(doc_ids), dtype=np.int32) % 4
    words, _, mask = blocked_layout(tokens, doc_ids, 5, block_docs)
    n_blocks, t_max = words.shape
    assert mask.sum() == len(doc_ids)
    ours = costs.gibbs_work_of(doc_ids, 3, 4)
    assert ours == costs.gibbs_sweep(24, 5, 3, 4)
    port = port_cost(n_blocks, t_max, block_docs, 3, 4, len(doc_ids))
    assert port.n_bytes >= ours.n_bytes
    assert port.ops[0][0] == ours.n_ops
