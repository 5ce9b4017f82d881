"""The sLSTM scan's route plan (``kernels/slstm_scan/ops.py::scan_plan``)
on the CPU: a pure function of (B, S, H, hd, R's dtype) that picks the
step, cluster or cooperative kernel and sizes it.  The kernels themselves
run only on the card (``tests/test_torch_cuda.py``); here the plan is
held to the served shape, the reduced test shapes and the edges, and its
constants to the kernel source's."""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.slstm_scan import ops  # noqa: E402
from repro_torch.kernels.slstm_scan.ref import zero_state  # noqa: E402

CU = (Path(ops.__file__).resolve().parents[1] / "csrc"
      / "slstm_scan.cu").read_text()
F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("b,s,h,hd,dt,route,ctas,units,rows,groups", [
    # xlstm-1.3b served: prefill on a 16-CTA cluster, decode on the step
    (4, 2048, 4, 512, BF16, "cluster", 16, 32, 4, 1),
    (4, 1, 4, 512, BF16, "step", 32, 16, 4, 1),
    # f32 R (4 MB a head at 512) takes the cooperative kernel at S >= 2
    (4, 2048, 4, 512, F32, "coop", 32, 16, 4, 1),
    (1, 2, 16, 512, F32, "coop", 32, 16, 1, 1),
    (4, 1, 4, 512, F32, "step", 64, 8, 4, 1),
    # bf16 H = 16: 16 independent clusters, in waves
    (1, 2, 16, 512, BF16, "cluster", 16, 32, 1, 1),
    (1, 16, 1, 512, BF16, "cluster", 16, 32, 1, 1),
    # P = 1, 2, 4, 8, 16 by hd (bf16); f32 R at the same hd: coop
    (4, 9, 2, 64, F32, "coop", 4, 16, 4, 1),
    (4, 9, 2, 128, F32, "coop", 8, 16, 4, 1),
    (4, 9, 2, 256, F32, "coop", 16, 16, 4, 1),
    (4, 9, 2, 128, BF16, "cluster", 1, 128, 4, 1),
    (4, 9, 2, 192, BF16, "cluster", 2, 96, 4, 1),
    (4, 9, 2, 256, BF16, "cluster", 4, 64, 4, 1),
    (4, 9, 2, 384, BF16, "cluster", 8, 48, 4, 1),
    (4, 9, 2, 448, BF16, "cluster", 16, 28, 4, 1),
    # batch chunks of 4 rows; groups of clusters once the chunks fill a CTA
    (1, 8, 4, 512, BF16, "cluster", 16, 32, 1, 1),
    (6, 8, 4, 512, BF16, "cluster", 16, 32, 4, 2),
    (9, 8, 4, 512, BF16, "cluster", 16, 32, 4, 3),
    (9, 8, 2, 256, BF16, "cluster", 4, 64, 8, 2),
    (9, 8, 2, 128, BF16, "cluster", 1, 128, 8, 2),
    (9, 8, 2, 40, BF16, "cluster", 1, 40, 9, 1),
    (17, 8, 4, 512, BF16, "cluster", 16, 32, 4, 5),
    (64, 8, 2, 64, BF16, "cluster", 1, 64, 16, 4),
    (9, 8, 2, 40, F32, "coop", 3, 16, 9, 1),
    (64, 8, 2, 64, F32, "coop", 4, 16, 64, 1),
    (8, 1, 4, 512, BF16, "step", 32, 16, 8, 1),
    (1, 1, 4, 512, BF16, "step", 32, 16, 1, 1),
    # the JAX kernel tests' shapes (f32 R) and the ragged ones
    (2, 32, 2, 16, F32, "coop", 1, 16, 2, 1),
    (4, 64, 4, 32, F32, "coop", 2, 16, 4, 1),
    (1, 48, 3, 8, F32, "coop", 1, 8, 1, 1),
    (3, 5, 2, 40, F32, "coop", 3, 16, 3, 1),
    (2, 32, 2, 16, BF16, "cluster", 1, 16, 2, 1),
    (3, 5, 2, 40, BF16, "cluster", 1, 40, 3, 1),
    (3, 1, 3, 8, F32, "step", 1, 8, 3, 1),
    (3, 1, 2, 40, BF16, "step", 3, 16, 3, 1),
    # edges: one unit; R too large for any cluster even in bf16
    (1, 2, 1, 1, F32, "coop", 1, 1, 1, 1),
    (1, 2, 1, 1, BF16, "cluster", 1, 1, 1, 1),
    (1, 1, 1, 1, BF16, "step", 1, 16, 1, 1),
    (4, 2, 4, 1024, BF16, "coop", 64, 16, 4, 1),
])
def test_scan_plan_routes_and_sizes(b, s, h, hd, dt, route, ctas, units,
                                    rows, groups):
    p = ops.scan_plan(b, s, h, hd, dt)
    assert (p.route, p.ctas, p.units, p.rows, p.groups) == (
        route, ctas, units, rows, groups)


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("hd", [1, 7, 8, 16, 40, 64, 96, 128, 200, 256,
                                384, 512, 640, 1024])
@pytest.mark.parametrize("b", [1, 4, 9, 33])
def test_cluster_plan_fits_and_takes_the_smallest_cluster(b, hd, dt):
    """f32 R never takes a cluster.  A cluster plan fits 227 KB, covers
    every unit and row, and no smaller power of two would fit; a coop
    plan of bf16 R means no cluster of <= 16 CTAs holds R."""
    p = ops.scan_plan(b, 3, 2, hd, dt)
    if dt == F32:
        assert p.route == "coop" and p.units == ops.units_per_cta(hd)
        assert p.ctas * p.units >= hd > (p.ctas - 1) * p.units
    elif p.route == "cluster":
        assert p.smem == ops.cluster_smem(hd, p.units, p.rows)
        assert p.smem <= ops.MAX_SHARED
        assert p.ctas in (1, 2, 4, 8, 16)
        assert p.ctas * p.units >= hd > (p.ctas - 1) * p.units
        assert p.rows * p.groups >= b > (p.groups - 1) * p.rows
        assert p.rows <= 4 * ops.MAX_CHUNKS
        if p.ctas > 1:
            smaller = -(-hd // (p.ctas // 2))
            assert ops.cluster_smem(hd, smaller, min(b, 4)) > ops.MAX_SHARED
    else:
        assert p.route == "coop"
        assert ops.cluster_smem(hd, -(-hd // 16), min(b, 4)) \
            > ops.MAX_SHARED


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("hd", [1, 8, 40, 512, 1000])
def test_step_plan_covers_every_unit_in_32_byte_groups(hd, dt):
    p = ops.scan_plan(3, 1, 2, hd, dt)
    assert p.route == "step" and p.smem == 0 and p.groups == 1
    assert p.units * torch.empty((), dtype=dt).element_size() == 32
    assert p.ctas * p.units >= hd > (p.ctas - 1) * p.units


def test_reduced_xlstm_shapes_take_the_cluster_and_step_routes():
    """The reduced xLSTM of the CPU model tests: prefill on one cluster
    per head in the model's bf16 (the cooperative kernel in f32), decode
    on the step route in both."""
    cfg = get_arch("xlstm-1.3b").reduced()
    hd = cfg.d_model // cfg.n_heads
    assert ops.scan_plan(2, 20, cfg.n_heads, hd, BF16).route == "cluster"
    assert ops.scan_plan(2, 20, cfg.n_heads, hd, F32).route == "coop"
    for dt in (F32, BF16):
        assert ops.scan_plan(2, 1, cfg.n_heads, hd, dt).route == "step"
    full = get_arch("xlstm-1.3b")
    hd = full.d_model // full.n_heads
    assert ops.scan_plan(4, 2048, full.n_heads, hd, BF16).ctas == 16


def test_scan_plan_refuses_an_empty_scan():
    for shape in [(0, 2, 1, 8), (1, 0, 1, 8), (1, 2, 0, 8), (1, 2, 1, 0)]:
        with pytest.raises(ValueError):
            ops.scan_plan(*shape, F32)


def test_plan_constants_match_the_kernel_source():
    """scan_plan sizes shared memory as cluster_smem in the .cu does;
    the constants it relies on are the kernel's."""
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))
    assert const("kMaxSharedBytes") == ops.MAX_SHARED
    assert const("kClusterThreads") == ops.CLUSTER_THREADS
    assert const("kMaxFinish") == ops.MAX_FINISH
    assert const("kStepThreads") == ops.STEP_THREADS
    assert "s.CS = s.C + 8;" in CU and "s.KS = s.NG <= 16 ? 16 / s.NG" in CU
    assert "(C + 63) / 64 * 64" in CU


def test_the_plain_path_counts_no_launch():
    """A CPU tensor takes the plain version on every route's shape; no
    route counter moves."""
    counters = ("slstm_scan_launches",) + tuple(
        f"slstm_{r}_launches" for r in ops.ROUTES)
    before = {c: getattr(ops, c) for c in counters}
    for s in (1, 3):
        x = torch.zeros((2, s, 4, 2, 8))
        out, st = ops.slstm_scan(x, torch.zeros((2, 8, 32)),
                                 *zero_state(2, 2, 8, "cpu"))
        assert out.shape == (2, s, 2, 8) and len(st) == 4
    assert {c: getattr(ops, c) for c in counters} == before
