"""``train/optim.py``'s tree helpers hold no reference to what they were
given once they return: a step's gradients go when their tree goes, not
when the garbage collector next runs (a reference cycle would keep a
float32 copy of the parameters alive into the next step)."""
import gc
import weakref

import pytest

torch = pytest.importorskip("torch")

from repro_torch.train.optim import leaves, tree_map, unflatten  # noqa: E402


def _tree():
    return {"b": [torch.ones(3), (torch.zeros(2), torch.ones(1))],
            "a": {"w": torch.full((2, 2), 2.0)}}


def test_unflatten_keeps_the_order_and_the_shape():
    tree = _tree()
    got = unflatten(tree, [x * 2 for x in leaves(tree)])
    assert isinstance(got["b"][1], tuple)
    for g, x in zip(leaves(got), leaves(tree)):
        assert torch.equal(g, x * 2)


@pytest.mark.parametrize("helper", ["unflatten", "tree_map"])
def test_tree_helpers_leave_no_reference_cycle(helper):
    tree = _tree()
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        values = [x + 1 for x in leaves(tree)]
        if helper == "unflatten":
            out = unflatten(tree, values)
        else:
            out = tree_map(lambda x: x + 1, tree)
        refs = [weakref.ref(x) for x in leaves(out)]
        del out, values
        assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()
