"""What the fault tests of both cells share.

Each case runs a whole cell on the CPU route at a tiny size, past the
harness's look for a card, with the program broken underneath by a
patch applied in the run's own process: the run must end with
``correct`` false (and with true for the unbroken program).  The cells'
own limits are used.  One card holds each cell, so no exchange between
cards can be left out.
"""
import json
import sys

import pytest

from bench.tests.tiny import tiny_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("tree"))


def control_readings(tree, cell, capsys):
    """The control's readings of ``cell``: the reference in bfloat16 in
    the program's place, then in float64."""
    sys.path.insert(0, str(tree / "bench"))
    try:
        import control
        assert control.ROOT == tree
        for dtype in ("bfloat16", "float64"):
            control.main(["--workload", cell, "--seeds", "2147483723",
                          "--dtype", dtype], device="cpu")
    finally:
        sys.path.remove(str(tree / "bench"))
        sys.modules.pop("control", None)
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
