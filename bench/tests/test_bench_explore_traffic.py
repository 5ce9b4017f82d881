"""The explore stream: seeded, every query a bucket of its level inside
the capital, the levels equally likely."""
import json
from pathlib import Path

import numpy as np
import pytest

from bench.traffic.explore import explore_queries, n_leaves

ROOT = Path(__file__).resolve().parents[2]


def _take(params, leaves, leaf, seed, analyst, n=600, tag="window"):
    s = explore_queries(params, leaves, leaf, seed, analyst, tag)
    return [next(s) for _ in range(n)]


@pytest.mark.parametrize("cell", ["nytimes-vb-explore", "pubmed-vb-explore"])
def test_every_query_is_an_aligned_bucket_inside_the_capital(cell):
    wl = json.loads((ROOT / "bench" / "workloads" / f"{cell}.json")
                    .read_text())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in bench["configs"]}[
        {w["name"]: w for w in bench["workloads"]}[cell]["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    leaf = cfg["capital"]["leaf_units"]
    leaves = n_leaves(cfg["corpus"]["attr_max"], leaf)
    qs = [q for a in range(wl["analysts"])
          for q in _take(wl, leaves, leaf, 2147483801, a, n=60)]
    for lo, hi in qs:
        width = (hi - lo) / leaf
        assert width in wl["widths_leaves"]
        assert lo % (width * leaf) == 0
        assert 0 <= lo and hi <= leaves * leaf
    assert {round((hi - lo) / leaf) for lo, hi in qs} \
        == set(wl["widths_leaves"])


def test_one_seed_gives_the_same_queries_and_another_seed_others():
    p = {"analysts": 4, "widths_leaves": [1, 2, 4, 8, 16, 32]}
    a = _take(p, 300, 1000.0, 2147483807, 2)
    assert a == _take(p, 300, 1000.0, 2147483807, 2)
    assert a != _take(p, 300, 1000.0, 2147483809, 2)
    assert a != _take(p, 300, 1000.0, 2147483807, 3)
    assert a != _take(p, 300, 1000.0, 2147483807, 2, tag="warmup")


def test_the_levels_are_equally_likely():
    p = {"analysts": 32, "widths_leaves": [1, 2, 4, 8, 16, 32]}
    qs = [q for a in range(32) for q in _take(p, 820, 10000.0, 7, a, n=30)]
    widths = np.array([round((hi - lo) / 10000.0) for lo, hi in qs])
    counts = [int((widths == w).sum()) for w in p["widths_leaves"]]
    # a low-discrepancy stream: each level within 2% of its sixth
    assert max(abs(c - len(qs) / 6) for c in counts) < 0.02 * len(qs)


def test_a_level_wider_than_the_capital_is_refused():
    with pytest.raises(ValueError):
        _take({"analysts": 1, "widths_leaves": [1, 64]}, 32, 1.0, 3, 0)
