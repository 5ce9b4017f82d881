"""The gapped cell refuses a broken timed path, and its control (see
``faults.py``)."""
import pytest

from bench.tests.faults import control_readings, tree  # noqa: F401
from bench.tests.tiny import run_cpu

CELL = "enron-gs-gapped"

GS_FAULTS = {
    "none": "",
    # the sampler hands back its starting state: no sweep runs
    "state_unchanged": """
import repro_torch.core.gibbs as _g
_orig = _g.cgs_fit_blocked
def _fit(*a, **k):
    k["sweeps"] = 0
    return _orig(*a, **k)
_g.cgs_fit_blocked = _fit
""",
    # a gap trains on the first half of its documents, counts doubled
    "half_left_out": """
from repro_torch.api.backend import DeviceBackend as _B
_orig = _B._train_gs_kernel
def _train(self, corpus, cfg, gen, global_nkv=None):
    if corpus.n_docs > 1:
        corpus = corpus.subset(corpus.attr[0], corpus.attr[corpus.n_docs // 2])
    out = _orig(self, corpus, cfg, gen, global_nkv)
    return {"delta_nkv": out["delta_nkv"] * 2.0}
_B._train_gs_kernel = _train
""",
    # one token of a gap changes its word where the gap model is made
    "token_altered": """
import numpy as _np
from repro_torch.api.backend import DeviceBackend as _B
_orig = _B._train_gs_kernel
def _train(self, *a, **k):
    out = _orig(self, *a, **k)
    n = out["delta_nkv"]
    t, w = _np.unravel_index(_np.argmax(n), n.shape)
    n[t, w] -= 1.0
    n[t, (w + 1) % n.shape[1]] += 1.0
    return out
_B._train_gs_kernel = _train
""",
    # one entry of every answer changes where the answer is made
    "answer_altered": """
import numpy as _np
from repro_torch.api.backend import DeviceBackend as _B
_m, _mm = _B.merge, _B.merge_many
def _alter(b):
    b = b.copy()
    b[0, _np.argmax(b[0])] *= 1.01
    return b
_B.merge = lambda self, *a, **k: _alter(_m(self, *a, **k))
_B.merge_many = lambda self, *a, **k: [_alter(b) for b in _mm(self, *a, **k)]
""",
}


@pytest.mark.parametrize("fault", sorted(GS_FAULTS))
def test_gapped_cell_refuses_a_broken_path(tree, fault):
    rc, res, err = run_cpu(tree, CELL, patch=GS_FAULTS[fault])
    assert rc == 0, err[-3000:]
    assert res["correct"] is (fault == "none"), res["checks"]


def test_the_control_comes_out_not_correct(tree, capsys):
    """The reference in bfloat16 in the program's place fails one of the
    cell's numbers; in float64 it fails none, so the numbers measure
    precision and not the reference's own randomness."""
    low, full = control_readings(tree, CELL, capsys)
    assert low["fails"], low
    assert not full["fails"], full
