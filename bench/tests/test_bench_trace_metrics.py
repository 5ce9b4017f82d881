"""The per-layer metrics that read the program's child spans under
"train" and "merge": a traced tiny CPU run of each cell prints them as
finite numbers, and the parts never add up to more than their parent."""
import json
import math

import pytest

from bench.tests.tiny import run_cpu, tiny_tree

GAP = ("gap_layout_ms", "gap_upload_ms", "gap_fit_ms", "gap_readback_ms")
MERGE = ("merge_fetch_ms", "merge_readback_ms")
WINDOW = ("window_layout_ms", "window_upload_ms", "window_readback_ms")


def _values(res, names):
    out = {}
    for n in names:
        assert n in res["metrics"], (n, sorted(res["metrics"]))
        assert res["metrics"][n]["unit"] == "ms"
        out[n] = res["metrics"][n]["value"]
        assert math.isfinite(out[n]) and out[n] >= 0.0, (n, out[n])
    return out


def test_gapped_cell_splits_gap_training_and_the_merge(tmp_path):
    rc, res, err = run_cpu(tiny_tree(tmp_path / "tree"), "enron-gs-gapped",
                           trace=1, seconds=2.0)
    assert rc == 0, err[-3000:]
    assert res["correct"], err[-3000:]
    gap = _values(res, GAP)
    assert sum(gap.values()) <= res["metrics"]["gap_train_ms"]["value"]
    merge = _values(res, MERGE)
    assert sum(merge.values()) <= res["metrics"]["merge_stage_ms"]["value"]
    assert not set(WINDOW) & set(res["metrics"])


def test_capital_cell_splits_the_windows_train_span(tmp_path):
    tree = tiny_tree(tmp_path / "tree")
    # the copy also reads the mean "train" span in the capital cell
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] == "gap_train_ms":
            m["workloads"].append("nytimes-vb-capital")
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, res, err = run_cpu(tree, "nytimes-vb-capital", trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"], err[-3000:]
    window = _values(res, WINDOW)
    assert sum(window.values()) <= res["metrics"]["gap_train_ms"]["value"]
    assert not set(GAP + MERGE) & set(res["metrics"])


@pytest.mark.parametrize("cell", ["nytimes-vb-capital", "enron-gs-gapped"])
def test_untraced_runs_print_no_span_metric(tmp_path, cell):
    rc, res, err = run_cpu(tiny_tree(tmp_path / "tree"), cell)
    assert rc == 0, err[-3000:]
    assert not set(GAP + MERGE + WINDOW) & set(res["metrics"])
