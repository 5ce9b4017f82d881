"""The explore cells refuse a broken merge, and their control: the
reference's merge in bfloat16 in the program's place comes out not
correct, in float64 correct."""
import json
import sys

import pytest

from bench.tests.explore_tiny import CELLS, explore_tree
from bench.tests.tiny import run_cpu

FAULTS = {
    "none": "",
    # each merged segment of more than one part loses its last part
    "part_dropped": """
from repro_torch.api.backend import DeviceBackend as _B
_m, _mm = _B.merge, _B.merge_many
def _drop(parts):
    return list(parts[:-1]) if len(parts) > 1 else list(parts)
_B.merge = lambda self, parts, *a, **k: _m(self, _drop(parts), *a, **k)
_B.merge_many = lambda self, lists, *a, **k: _mm(
    self, [_drop(p) for p in lists], *a, **k)
""",
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return explore_tree(tmp_path_factory.mktemp("tree"))


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_explore_cell_refuses_a_dropped_part(tree, fault):
    rc, res, err = run_cpu(tree, CELLS[0], seed=2147483779,
                           patch=FAULTS[fault])
    assert rc == 0, err[-3000:]
    assert res["correct"] is (fault == "none"), res["checks"]
    if fault != "none":
        assert res["checks"]["vb_beta_gap"]["value"] > 0.01


@pytest.mark.parametrize("cell", CELLS)
def test_the_explore_control_comes_out_not_correct(tree, cell, capsys):
    sys.path.insert(0, str(tree / "bench"))
    try:
        import control_explore
        assert control_explore.ROOT == tree
        for dtype in ("bfloat16", "float64"):
            control_explore.main(["--workload", cell, "--seeds",
                                  "2147483789", "--dtype", dtype],
                                 device="cpu")
    finally:
        sys.path.remove(str(tree / "bench"))
        sys.modules.pop("control_explore", None)
    low, full = [json.loads(line) for line in
                 capsys.readouterr().out.strip().splitlines()]
    assert low["fails"] == ["vb_beta_gap"], low
    assert not full["fails"], full
