"""The explore cells run whole on the CPU route at a tiny size, through
``run.py``'s ``main``: correct, their end-to-end metrics untraced and
their span and counter metrics traced (see ``explore_tiny.py``)."""
import pytest

from bench.tests.explore_tiny import CELLS, explore_tree
from bench.tests.tiny import run_cpu

SPAN_METRICS = {"client_p95_ms.explore", "plan_ms.explore",
                "merge_stage_ms.explore", "merge_fetch_ms.explore",
                "merge_readback_ms.explore", "merge_finish_ms.explore",
                "merge_parts.explore", "coalesce_width.explore"}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return explore_tree(tmp_path_factory.mktemp("tree"))


@pytest.mark.parametrize("cell", CELLS)
def test_explore_cell_runs_correct_on_the_cpu_route(tree, cell):
    rc, res, err = run_cpu(tree, cell, seed=2147483761)
    assert rc == 0, err[-3000:]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"queries_per_s", "setup_s"}
    assert res["metrics"]["queries_per_s"]["value"] > 0
    assert set(res["checks"]) == {"tiling_docs", "vb_beta_gap"}


@pytest.mark.parametrize("cell", CELLS)
def test_explore_cell_reads_its_spans_and_counter_traced(tree, cell):
    """Off the card the device metrics find nothing to read and are left
    out; every span and counter metric reads a number."""
    rc, res, err = run_cpu(tree, cell, seed=2147483767, trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == SPAN_METRICS
    # every answer merges at least one leaf, the widest 8
    assert 1.0 <= res["metrics"]["merge_parts.explore"]["value"] <= 8.0
    # the service drains groups of 1 to max_width queries
    assert 1.0 <= res["metrics"]["coalesce_width.explore"]["value"] <= 8.0


def test_the_capital_stays_resident_through_the_loop(tree):
    """Set-up leaves every leaf in the LRU, at a capacity of exactly the
    leaves, and the tenants' sessions do not clear it: the loop's merges
    miss nothing."""
    import json
    import time

    import torch

    from bench.entries import service_explore
    from bench.entries.common import Ctx
    from bench.traffic.explore import n_leaves

    cfg = json.loads((tree / "bench/configs/pubmed-vb.json").read_text())
    wl = json.loads((tree / "bench/workloads/pubmed-vb-explore.json")
                    .read_text())
    leaf = cfg["capital"]["leaf_units"]
    leaves = n_leaves(cfg["corpus"]["attr_max"], leaf)
    cfg["backend"]["capacity"] = leaves
    ctx = Ctx(name="pubmed-vb-explore", config=cfg, workload=wl,
              seed=2147483771, seconds=0.0, trace=False,
              device=torch.device("cpu"), t_start=time.perf_counter())
    g, leaf_of, svc, backend, _ = service_explore.build(ctx)
    try:
        assert len(leaf_of) == leaves == len(backend.cache)
        sent = service_explore.closed_loop(
            svc, ctx, "window", service_explore.Collector(leaf_of, leaf),
            leaves, count=60)
    finally:
        svc.close()
    assert all(a.state == "answered" for a in sent)
    backend._sync_cache_counters()
    assert backend.stats.cache_misses == 0
    assert backend.stats.cache_hits == backend.stats.merge_parts > 0
