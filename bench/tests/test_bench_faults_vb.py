"""The capital cell refuses a broken timed path, and its control (see
``faults.py``)."""
import pytest

from bench.tests.faults import control_readings, tree  # noqa: F401
from bench.tests.tiny import run_cpu

CELL = "nytimes-vb-capital"

VB_FAULTS = {
    "none": "",
    # the fit hands back lambda0: no iteration runs
    "state_unchanged": """
import dataclasses as _dc
import repro_torch.core.vb as _vb
_orig = _vb.vb_fit
def _fit(x, gen, cfg, **k):
    return _orig(x, gen, _dc.replace(cfg, max_iters=0), **k)
_vb.vb_fit = _fit
""",
    # a window fits the first half of its documents, statistics doubled
    "half_left_out": """
from repro_torch.api.backend import DeviceBackend as _B
_orig = _B._train_vb_kernel
def _train(self, corpus, cfg, gen):
    if corpus.n_docs > 1:
        corpus = corpus.subset(corpus.attr[0], corpus.attr[corpus.n_docs // 2])
    lam = _orig(self, corpus, cfg, gen)["lam"]
    return {"lam": cfg.eta + 2.0 * (lam - cfg.eta)}
_B._train_vb_kernel = _train
""",
    # one token's count moves to the next word where lambda is made
    "token_altered": """
import numpy as _np
from repro_torch.api.backend import DeviceBackend as _B
_orig = _B._train_vb_kernel
def _train(self, *a, **k):
    out = _orig(self, *a, **k)
    lam = out["lam"]
    t, w = _np.unravel_index(_np.argmax(lam), lam.shape)
    lam[t, w] -= 1.0
    lam[t, (w + 1) % lam.shape[1]] += 1.0
    return out
_B._train_vb_kernel = _train
""",
}


@pytest.mark.parametrize("fault", sorted(VB_FAULTS))
def test_capital_cell_refuses_a_broken_path(tree, fault):
    rc, res, err = run_cpu(tree, CELL, patch=VB_FAULTS[fault])
    assert rc == 0, err[-3000:]
    assert res["correct"] is (fault == "none"), res["checks"]


def test_the_control_comes_out_not_correct(tree, capsys):
    """The reference in bfloat16 in the program's place fails one of the
    cell's numbers; in float64 it fails none, so the numbers measure
    precision and not the reference's own randomness."""
    low, full = control_readings(tree, CELL, capsys)
    assert low["fails"], low
    assert not full["fails"], full
