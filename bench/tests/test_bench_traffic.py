"""The generated corpus, capital and query streams."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.traffic import corpus as gen
from bench.traffic import queries

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


def _small(seed, **kw):
    args = dict(mean_doc_len=20, alpha=0.1, eta=0.05, attr_max=300.0,
                seed=seed, device=CPU)
    args.update(kw)
    return gen.make_corpus(300, 150, 5, **args)


def test_one_seed_gives_the_same_bytes_and_another_seed_others():
    a, b, c = _small(2147483701), _small(2147483701), _small(2147483702)
    for f in ("tokens", "doc_ids", "offsets", "attr", "z"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    assert a.tokens.tobytes() != c.tokens.tobytes()
    assert a.attr.tobytes() != c.attr.tobytes()


def test_corpus_is_well_formed():
    c = _small(7)
    assert c.n_docs == 300 and c.vocab_size == 150
    assert np.all(np.diff(c.offsets) >= 4)
    assert np.array_equal(np.repeat(np.arange(300), np.diff(c.offsets)),
                          c.doc_ids)
    assert c.tokens.min() >= 0 and c.tokens.max() < 150
    assert c.z.min() >= 0 and c.z.max() < 5
    assert np.all(np.diff(c.attr) >= 0)
    assert 0.0 <= c.attr[0] and c.attr[-1] < 300.0


@pytest.mark.parametrize("config", ["enron-gs", "nytimes-vb"])
def test_sizes_match_the_configuration_file(config):
    """Documents, V and the mean length as the file states (NYTimes at a
    hundredth of its documents, so the CPU can hold it)."""
    c = json.loads((ROOT / "bench" / "configs" / f"{config}.json")
                   .read_text())["corpus"]
    n_docs = c["n_docs"] if config == "enron-gs" else c["n_docs"] // 100
    g = gen.make_corpus(n_docs, c["vocab_size"], c["n_topics"],
                        mean_doc_len=c["mean_doc_len"], alpha=c["alpha"],
                        eta=c["eta"], attr_max=c["attr_max"], seed=11,
                        device=CPU)
    assert g.n_docs == n_docs and g.vocab_size == c["vocab_size"]
    mean = g.n_tokens / g.n_docs
    # Poisson lengths: the sample mean lies within 5 standard errors
    assert abs(mean - c["mean_doc_len"]) < 5 * np.sqrt(
        c["mean_doc_len"] / n_docs)
    assert g.tokens.max() < c["vocab_size"]


@pytest.mark.parametrize("kind", ["vb", "gs"])
def test_each_leaf_holds_the_counts_of_its_own_tokens(kind):
    c = _small(3)
    for lo, hi in gen.leaves(300.0, 70.0):
        stat = gen.capital_stat(c, lo, hi, kind, 0.01, CPU)
        want = np.zeros((5, 150), np.float64)
        d0, d1 = np.searchsorted(c.attr, [lo, hi])
        t0, t1 = c.offsets[d0], c.offsets[d1]
        np.add.at(want, (c.z[t0:t1], c.tokens[t0:t1]), 1.0)
        if kind == "vb":
            want += 0.01
        # exact counts; eta + counts rounded once to float32
        np.testing.assert_allclose(stat, want, rtol=2 ** -23, atol=0)


def test_leaves_tile_the_attribute_range():
    ls = list(gen.leaves(1050.0, 100.0))
    assert ls[0] == (0.0, 100.0) and ls[-1] == (1000.0, 1100.0)
    assert all(a[1] == b[0] for a, b in zip(ls, ls[1:]))


def test_analyst_streams_are_seeded_and_in_range():
    p = {"analysts": 3, "width_min": 20.0, "width_max": 50.0}
    take = lambda s, a: [q for q, _ in zip(  # noqa: E731
        queries.analyst_queries(p, 300.0, s, a), range(200))]
    a = take(5, 1)
    assert a == take(5, 1) and a != take(6, 1) and a != take(5, 2)
    w = np.array([hi - lo for lo, hi in a])
    assert w.min() >= 20.0 and w.max() <= 50.0
    assert min(lo for lo, _ in a) >= 0.0 and max(hi for _, hi in a) <= 300.0
    # low discrepancy: every quarter of the width range gets its share
    hist = np.histogram(w, bins=4, range=(20.0, 50.0))[0]
    assert hist.min() >= 40


def test_capital_windows_wrap():
    w = queries.capital_windows(100.0, 350.0, 9)
    got = [next(w) for _ in range(4)]
    assert all(hi - lo == 100.0 for lo, hi in got)
    assert sorted(lo for lo, _ in got[:3]) == [0.0, 100.0, 200.0]
    assert got[3] == got[0]
