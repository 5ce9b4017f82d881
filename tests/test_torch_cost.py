"""The dry run's op counter (``repro_torch.launch.cost``) and the kernels'
``cost(...)``: the counterparts of ``tests/test_hlo_analyzer.py``.

FLOPs against ``torch.utils.flop_counter.FlopCounterMode``; a Python loop
of products counted once per product (eager code has no ``while`` body
whose trip count could be lost); a gradient step at least twice its
forward; each collective of ``distributed/sharding.py`` at the ring
formula's wire bytes on a (2, 4) grid of fake cards; the same counts
under ``torch.inference_mode`` as under ``no_grad``; row-reading and
row-writing ops at their rows; the kernel wrappers' shape-only routes;
a fake tensor refused by ``kernels.common.launch``; and every kernel's
``cost(...)`` giving ``PERF.md`` §6's bound at the shapes timed there.
"""
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.gibbs_sweep import ops as gibbs_ops  # noqa: E402
from repro_torch.kernels.merge_topics import ops as merge_ops  # noqa: E402
from repro_torch.kernels.slstm_scan import ops as slstm_ops  # noqa: E402
from repro_torch.launch.cost import OpCounter, kernel_interior  # noqa: E402
from repro_torch.launch.mesh import make_env  # noqa: E402

X = (64, 128)
W = (128, 128)
DOT = 2 * 64 * 128 * 128
bf16, f32 = torch.bfloat16, torch.float32


def _xw():
    g = torch.Generator().manual_seed(0)
    return torch.randn(X, generator=g), torch.randn(W, generator=g)


def test_loop_free_matches_flop_counter_mode():
    x, w = _xw()
    with OpCounter() as c:
        torch.tanh(x @ w) @ w
    with FlopCounterMode(display=False) as f:
        torch.tanh(x @ w) @ w
    assert c.total("flops") == f.get_total_flops() == 2 * DOT


def test_inference_mode_counts_as_no_grad():
    """``torch.inference_mode`` hands the counter composite ops whole
    (``matmul``, ``to``): it counts the ops they are made of, the
    products' FLOPs and a copy's bytes received on a fake card, as under
    ``no_grad``."""
    env = make_env("node")
    got = []
    for mode in (torch.no_grad, torch.inference_mode):
        with FakeTensorMode():
            x, w = torch.empty(X), torch.empty(W)
            with OpCounter() as c, mode():
                (x @ w).to(env.cells[1])
        got.append((c.total("flops"), c.total("hbm_bytes"),
                    c.total("copy_bytes_in")))
    assert got[0] == got[1]
    assert got[0][0] == DOT and got[0][2] == 64 * 128 * 4


def test_loop_counts_every_product():
    x, w = _xw()
    with OpCounter() as c:
        y = x
        for _ in range(9):
            y = y @ w
    assert c.total("flops") == 9 * DOT


def test_nested_loops_count_every_product():
    x, w = _xw()
    with OpCounter() as c:
        y = x
        for _ in range(5):
            for _ in range(4):
                y = y @ w
    assert c.total("flops") == 20 * DOT


def test_grad_counts_forward_and_backward():
    x, w = _xw()
    w.requires_grad_(True)
    with OpCounter() as c:
        loss = ((x @ w) ** 2).sum()
        torch.autograd.grad(loss, [w])
    # the forward product and dL/dw's at least
    assert c.total("flops") >= 2 * DOT


# a (2, 4) grid of fake cards; each cell's block is (4, 6) float32 = 96 B
BLOCK = (4, 6)
NB = 4 * 6 * 4


@pytest.mark.parametrize("kind, run, wire", [
    # all-reduce over "model" (n = 4): 2 · size · (n - 1) / n
    ("all-reduce", lambda xs, env: sh.psum(xs, env, "model"),
     2 * NB * 3 / 4),
    # all-gather over "model" along dim 0: the gathered (16, 6) · 3/4
    ("all-gather", lambda xs, env: sh.all_gather(xs, env, "model", 0),
     4 * NB * 3 / 4),
    # all-to-all over "model": size · (n - 1) / n
    ("all-to-all", lambda xs, env: sh.all_to_all(xs, env, "model", 0, 1),
     NB * 3 / 4),
    # collective-permute: size
    ("collective-permute", lambda xs, env: sh.ppermute(xs, env, "model"),
     NB),
])
def test_collectives_count_ring_wire_bytes(kind, run, wire):
    env = make_env("node")
    with FakeTensorMode():
        xs = [torch.empty(BLOCK, device=d) for d in env.cells]
        with OpCounter() as c:
            out = run(xs, env)
    assert [o.device for o in out] == list(env.cells)
    assert len(c.devices) == 8
    for d in env.cells:
        got = c.devices[d]
        assert got.collective_wire_bytes == pytest.approx(wire)
        assert got.collective_counts == {kind: 1}
        assert got.collective_bytes_by_kind == {kind: pytest.approx(wire)}


def test_psum_over_data_counts_its_group():
    env = make_env("node")
    with FakeTensorMode():
        xs = [torch.empty(BLOCK, device=d) for d in env.cells]
        with OpCounter() as c:
            sh.psum(xs, env, "data")
    assert c.max("collective_wire_bytes") == pytest.approx(2 * NB * 1 / 2)


def test_no_counter_no_report():
    env = make_env("node")
    with FakeTensorMode():
        xs = [torch.empty(BLOCK, device=d) for d in env.cells]
        out = sh.psum(xs, env, "model")
    assert len(out) == 8


def test_index_select_counts_only_its_rows():
    table = torch.zeros((1000, 64))
    idx = torch.tensor([3, 7, 11], dtype=torch.int64)
    with OpCounter() as c:
        table.index_select(0, idx)
    # 3 rows read and written, the indices read; not the 1000-row table
    assert c.total("hbm_bytes") == 2 * 3 * 64 * 4 + 3 * 8


def test_index_copy_counts_only_its_rows():
    cache = torch.zeros((4, 1000, 8))
    new = torch.ones((4, 1, 8))
    idx = torch.tensor([5], dtype=torch.int64)
    with OpCounter() as c:
        cache.index_copy_(1, idx, new)
    assert c.total("hbm_bytes") == 2 * 4 * 8 * 4 + 8


def test_views_move_nothing_and_copies_move_their_bytes():
    x = torch.zeros((16, 32))
    with OpCounter() as c:
        y = x.t()[2:5]
        assert c.total("hbm_bytes") == 0
        y.contiguous()
    assert c.total("hbm_bytes") == 2 * 3 * 16 * 4


def test_kernel_interior_marks_its_bytes():
    x, w = _xw()
    with kernel_interior():                  # no counter: a no-op
        x + 1
    with OpCounter() as c:
        x + 1
        with kernel_interior():
            x * 2
    one = 2 * 64 * 128 * 4
    assert c.total("hbm_bytes") == 2 * one
    assert c.total("hbm_bytes_kernel_interior") == one


def test_memory_peak_and_release_on_a_fake_card():
    dev = torch.device("meta", 3)
    with FakeTensorMode():
        a = torch.empty((1024,), device=dev)
        with OpCounter() as c:
            assert c.track([a, a[:10]]) == {dev: 4096}
            b = a * 2
            del b
            d = a + 1
            assert c.devices[dev].live_bytes == 2 * 4096
    assert c.devices[dev].peak_bytes == 2 * 4096
    del d


def test_fake_tensor_reaching_launch_raises(monkeypatch):
    def no_library():
        raise AssertionError("launch loaded the library for a fake tensor")

    monkeypatch.setattr(common, "load_library", no_library)
    with FakeTensorMode():
        t = torch.empty((4, 4), device="cuda:0")
        with pytest.raises(common.KernelError, match="fake tensor"):
            common.launch("flash_attention", "mlego_flash_attention",
                          t.device, t, 4, common.stream_of(t))


SHAPE_ONLY = {
    "flash_attention": lambda d: (
        flash_ops.flash_attention(
            torch.empty((2, 64, 8, 64), dtype=bf16, device=d),
            torch.empty((2, 64, 2, 64), dtype=bf16, device=d),
            torch.empty((2, 64, 2, 64), dtype=bf16, device=d),
            window=16, q_offset=64, return_lse=True),
        flash_ops.cost(2, 64, 8, 2, 64, bf16, window=16, q_offset=64,
                       return_lse=True),
        [((2, 64, 8, 64), f32), ((2, 64, 8), f32)]),
    "decode_attention": lambda d: (
        decode_ops.decode_attention(
            torch.empty((2, 1, 8, 64), dtype=bf16, device=d),
            torch.empty((2, 300, 2, 64), dtype=bf16, device=d),
            torch.empty((2, 300, 2, 64), dtype=bf16, device=d),
            torch.empty((), dtype=torch.int32, device=d)),
        decode_ops.cost(2, 300, 8, 2, 64, bf16, 299),
        [((2, 1, 8, 64), bf16)]),
    "slstm_scan": lambda d: (
        slstm_ops.slstm_scan(
            torch.empty((2, 16, 4, 4, 32), dtype=bf16, device=d),
            torch.empty((4, 32, 128), dtype=bf16, device=d),
            *(torch.empty((2, 4, 32), device=d) for _ in range(4))),
        slstm_ops.cost(2, 16, 4, 32, bf16, bf16),
        [((2, 16, 4, 32), bf16)] + [((2, 4, 32), f32)] * 4),
}


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in _flat(v)]
    return [x]


@pytest.mark.parametrize("name", sorted(SHAPE_ONLY))
@pytest.mark.parametrize("device", ["meta:2", "cuda:1"])
def test_shape_only_route_reports_its_cost(name, device):
    """A fake tensor off the CPU: the wrapper's checks, empty outputs of
    the kernel's shapes, one launch and ``cost(...)`` to the counter, and
    nothing computed or launched (``common.launch`` would refuse it)."""
    with FakeTensorMode():
        with OpCounter() as c:
            out, want, shapes = SHAPE_ONLY[name](torch.device(device))
    got = [(tuple(t.shape), t.dtype) for t in _flat(out)]
    assert got == shapes
    assert all(t.device == torch.device(device) for t in _flat(out))
    d = c.devices[torch.device(device)]
    assert d.kernel_launches == {name: 1}
    assert d.flops == want.flops and d.hbm_bytes == want.n_bytes
    assert flash_ops.flash_attention_launches == 0
    assert decode_ops.decode_attention_launches == 0
    assert slstm_ops.slstm_scan_launches == 0


def test_shape_only_route_runs_the_checks():
    with FakeTensorMode():
        q = torch.empty((2, 64, 8, 48), dtype=bf16, device="meta:0")
        k = torch.empty((2, 64, 2, 48), dtype=bf16, device="meta:0")
        with pytest.raises(ValueError, match="hd in"):
            flash_ops.flash_attention(q, k, k)


# PERF.md §6's bound column (ms, by) at the shapes timed there
BOUNDS = [
    ("merge n=8", lambda: merge_ops.cost(8, 100, 8192), 0.0088, "bytes"),
    ("ragged", lambda: merge_ops.segments_cost([1, 3, 8, 2], 100, 8192),
     0.0176, "bytes"),
    ("batched", lambda: merge_ops.batch_cost(4, 8, 100, 8192), 0.0352,
     "bytes"),
    ("exact scan", lambda: gibbs_ops.exact_cost(60153, 1000, 100, 8192),
     0.0035, "bytes"),
    ("flash bf16", lambda: flash_ops.cost(4, 2048, 16, 8, 128, bf16),
     0.0695, "operations"),
    # §6 writes 1.026 (three digits)
    ("flash f32", lambda: flash_ops.cost(4, 2048, 16, 8, 128, f32),
     1.0262, "operations"),
    ("flash G=16 window", lambda: flash_ops.cost(
        2, 4096, 16, 1, 256, bf16, window=2048), 0.2085, "operations"),
    ("flash encoder", lambda: flash_ops.cost(
        4, 1536, 6, 6, 64, bf16, causal=False), 0.0147, "operations"),
    ("flash llava", lambda: flash_ops.cost(2, 4096, 56, 8, 128, bf16),
     0.4865, "operations"),
    ("flash decoder", lambda: flash_ops.cost(4, 384, 6, 6, 64, bf16),
     0.0014, "bytes"),
    ("flash ring step 0", lambda: flash_ops.cost(
        2, 1024, 16, 8, 128, bf16, return_lse=True), 0.0101, "bytes"),
    ("flash ring step 1024", lambda: flash_ops.cost(
        2, 1024, 16, 8, 128, bf16, q_offset=1024, return_lse=True),
     0.0174, "operations"),
    ("decode bf16", lambda: decode_ops.cost(4, 2112, 16, 8, 128, bf16,
                                            2100), 0.0103, "bytes"),
    ("decode f32", lambda: decode_ops.cost(4, 2112, 16, 8, 128, f32, 2100),
     0.0206, "bytes"),
    ("decode whisper", lambda: decode_ops.cost(4, 448, 6, 6, 64, bf16, 447),
     0.0008, "bytes"),
    ("decode shard", lambda: decode_ops.cost(
        2, 1040, 16, 8, 128, bf16, 1030, return_lse=True), 0.0025, "bytes"),
    ("decode empty shard", lambda: decode_ops.cost(
        2, 1040, 16, 8, 128, bf16, -1050, return_lse=True), 0.0000,
     "bytes"),
    ("slstm cluster", lambda: slstm_ops.cost(4, 2048, 4, 512, bf16, bf16),
     0.2135, "operations"),
    ("slstm step", lambda: slstm_ops.cost(4, 1, 4, 512, bf16, bf16), 0.0026,
     "bytes"),
    ("slstm cooperative", lambda: slstm_ops.cost(4, 2048, 4, 512, f32, f32),
     1.0307, "operations"),
    ("slstm chain cell", lambda: slstm_ops.cost(2, 1024, 4, 512, bf16,
                                                bf16), 0.0534,
     "operations"),
]


@pytest.mark.parametrize("label, make, ms, by", BOUNDS,
                         ids=[b[0] for b in BOUNDS])
def test_cost_gives_the_bound_column(label, make, ms, by):
    got_ms, got_by = make().bound_ms()
    assert (round(got_ms, 4), got_by) == (ms, by)
