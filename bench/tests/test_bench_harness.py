"""The harness finds configurations, cells and per-layer metrics by
name, and refuses to run where it must."""
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bench.tests.tiny import ROOT, run_cpu, tiny_tree


def _digests(tree: Path) -> dict:
    return {str(p.relative_to(tree)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted(tree.rglob("*")) if p.is_file()}


def test_a_new_configuration_cell_and_metric_are_found_by_name(tmp_path):
    """Add a configuration, a cell and a per-layer metric as new files and
    entries; the run finds and reads them, and no existing file but
    BENCHMARK.json (which gains entries) changes."""
    tree = tiny_tree(tmp_path / "tree")
    before = _digests(tree)
    conf = json.loads((tree / "bench/configs/enron-gs.json").read_text())
    conf["name"] = "tiny-gs"
    conf["capital"]["leaf_units"] = 40
    (tree / "bench/configs/tiny-gs.json").write_text(json.dumps(conf))
    cell = json.loads(
        (tree / "bench/workloads/enron-gs-gapped.json").read_text())
    cell["width_min"], cell["width_max"] = 100, 200
    (tree / "bench/workloads/tiny-gs-gapped.json").write_text(
        json.dumps(cell))
    (tree / "bench/metrics/answers_traced.py").write_text(
        '"""answers_traced: queries answered in the traced window."""\n\n\n'
        "def read(t):\n    return float(t.answered) if t.answered else None\n")
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-gs", "source": "a test",
                             "file": "bench/configs/tiny-gs.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-gs-gapped", "config": "tiny-gs",
                               "traffic": "gapped", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "queries_per_s":
            m["workloads"].append("tiny-gs-gapped")
    bench["per_layer"].append({
        "name": "answers_traced", "unit": "queries", "better": "higher",
        "source": "host_clock", "layer": "service", "moves": "queries_per_s",
        "workloads": ["tiny-gs-gapped"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tree)
    changed = {k for k in before if before[k] != after[k]}
    assert changed == {"BENCHMARK.json"}

    rc, res, err = run_cpu(tree, "tiny-gs-gapped", trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"], err[-3000:]
    assert res["metrics"]["answers_traced"]["value"] >= 1
    assert res["metrics"]["answers_traced"]["unit"] == "queries"
    assert list(res)[-1] == "checks"
    rc, res, err = run_cpu(tree, "tiny-gs-gapped", trace=0)
    assert rc == 0, err[-3000:]
    assert set(res["metrics"]) == {"queries_per_s", "setup_s"}


@pytest.mark.parametrize("cell", ["nytimes-vb-capital", "enron-gs-gapped"])
def test_each_cell_runs_correct_on_the_cpu_route(tmp_path, cell):
    rc, res, err = run_cpu(tiny_tree(tmp_path / "tree"), cell)
    assert rc == 0, err[-3000:]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert res["metrics"]["setup_s"]["value"] > 0
    # each number compared is printed beside its limit, last on stderr
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") for line in tail)


def test_the_command_needs_the_card():
    """On a host with no CUDA card the command prints no result."""
    r = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "enron-gs-gapped",
         "--seed", "2147483713", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_the_benchmark_alone_does_not_run(tmp_path):
    """A directory that holds only BENCHMARK.json and bench/ has no
    program: the run fails and prints no result."""
    rc, res, err = run_cpu(tiny_tree(tmp_path / "tree"), "enron-gs-gapped",
                           with_src=False)
    assert rc != 0 and res is None
    assert "repro_torch" in err
