"""The port's dry run (``repro_torch.launch.{specs,mesh,dryrun}``) against
JAX's lowering of the same cells.

JAX runs once, in one subprocess with
``--xla_force_host_platform_device_count=8``: ``repro.launch.specs``'s
train, prefill and decode specs for the reduced config of each family
(dense, moe, ssm, hybrid, vlm, audio) at a small shape on a (2, 4)
("data", "model") mesh, lowered and compiled once each; it reports
``memory_analysis()``, the per-device bytes of the specs' argument and
output leaves under their shardings, the arguments XLA drops as unused,
and ``repro.launch.hlo_analyzer.analyze_hlo(...).flops``.  (It imports
neither ``repro.launch.dryrun``, which forces 512 devices at import, nor
anything of the port.)  The port costs the same 18 cells on its "node"
grid of fake cards, in two subprocesses of 9 cells; another writes the
full-width qwen3-moe-235b-a22b prefill_32k record and reports its peak
RSS, and another runs ``launch/train.py --dry``; all five run at once.

Bytes, exactly, with every difference named:

  * argument — on the first card the port holds JAX's bytes; on the last
    card 4 bytes fewer in train and decode, because the port keeps the
    step counter (train) and the position (decode) on the first cell
    only, where JAX replicates the scalar.  XLA's ``argument_size``
    leaves out the parameters the step never reads (the encoder's weights
    in whisper's decode step, ``pos`` in xLSTM's).
  * output — XLA's ``output_size`` adds an 8-byte pointer per output leaf
    (the output tuple's table).  The port joins the logits whole on the
    first cell (JAX leaves them (dp, None, tp)-sharded): its last card
    holds no logits, its first all of them.  In training the update runs
    on the pieces (``train/trainer.py``), so every card holds only its
    pieces of the updated masters and optimizer state, as JAX's do; the
    first cell also holds the step counter and the 4 metrics (20 bytes),
    which JAX replicates: card 0 holds JAX's bytes, the others 20 fewer.
    Card 0's peak lies within 10% of the busiest other card's.  The
    record's ``argument`` is the busiest card's, which need not be card 0.

FLOPs, within per-mode bounds (both count dots only):

  * prefill within 3%: the same products; the flash kernel's cost counts
    the causal pairs of a diagonal block where JAX's jnp ring computes the
    whole block.  For xLSTM, JAX's carry chain over the 4 model ranks runs
    every rank's local sLSTM scan at each of its 4 steps (SPMD: a rank
    keeps the step that is its turn, ``recurrent.py:232-243``), and the
    model runs the chain twice (for h, then for the final state): 8 scans
    a card where the port's chain runs each cell's once, so the port's
    count plus 7 scans' products is JAX's;
  * train within 12%: the same forward, remat and backward, reordered
    (the port recomputes each head chunk in the backward, JAX keeps the
    logits; the port's ring skips blocks above the diagonal, JAX's masks
    them);
  * decode within 5%: the step is weight-stationary on both (each card
    multiplies by its own pieces of the weights, ``Model._grid_decode``),
    so each card runs its share of every product by a weight, and
    attention runs on the cache's and the rolling window's shards.  The
    math that reads no weight (xLSTM's sLSTM step and mLSTM readout,
    whisper's cross attention over the cached encoder K/V) runs on each
    "model" rank's block of heads, as XLA splits JAX's.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import make_env  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("qwen3-1.7b", "qwen3-moe-235b-a22b", "xlstm-1.3b",
            "recurrentgemma-9b", "llava-next-34b", "whisper-tiny")
SHAPES = {"train": ShapeConfig("train_small", 32, 4, "train"),
          "prefill": ShapeConfig("prefill_small", 32, 4, "prefill"),
          "decode": ShapeConfig("decode_small", 32, 4, "decode")}
CELLS = [(a, m) for a in FAMILIES for m in SHAPES]
KEYS = ("arch", "shape", "mesh", "n_devices", "mode", "optimizer", "card",
        "trace_s", "bytes_per_device", "op_analysis", "roofline", "fits")
BYTE_KEYS = ("argument", "output", "temp", "peak")
OP_KEYS = ("flops", "hbm_bytes_kernel_interior", "hbm_bytes",
           "collective_wire_bytes", "collective_counts",
           "collective_bytes_by_kind")
ROOF_KEYS = ("compute_s", "memory_s", "collective_s", "memory_kernelized_s",
             "dominant")

JAX_BODY = r'''
import json, sys
import numpy as np
import jax
from repro.configs import ARCHS
from repro.configs.base import ShapeConfig
from repro.distributed.sharding import MeshEnv
from repro.launch import specs as S
from repro.launch.hlo_analyzer import analyze_hlo

cells, shapes, dst = json.loads(sys.argv[1]), json.loads(sys.argv[2]), \
    sys.argv[3]
auto = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(auto,) * 2)
env = MeshEnv(mesh=mesh, profile="train")
make = {"train": S.train_spec, "prefill": S.prefill_spec,
        "decode": S.decode_spec}

def leaf_bytes(tree, shardings):
    leaves = jax.tree_util.tree_leaves(tree)
    shs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    assert len(leaves) == len(shs)
    return [int(np.prod(s.shard_shape(l.shape))) * l.dtype.itemsize
            for l, s in zip(leaves, shs)]

out = {}
for arch, mode in cells:
    cfg = ARCHS[arch].reduced()
    spec = make[mode](cfg, ShapeConfig(*shapes[mode]), env)
    jitted = jax.jit(spec.step, in_shardings=spec.in_shardings,
                     out_shardings=spec.out_shardings)
    with mesh:
        lowered = jitted.lower(*spec.args)
        compiled = lowered.compile()
        outs = jax.eval_shape(spec.step, *spec.args)
    kept = lowered._lowering.compile_args["kept_var_idx"]
    args = leaf_bytes(spec.args, spec.in_shardings)
    res = leaf_bytes(outs, spec.out_shardings)
    mem = compiled.memory_analysis()
    out[f"{arch}/{mode}"] = dict(
        argument=int(mem.argument_size_in_bytes),
        output=int(mem.output_size_in_bytes),
        argument_leaves=sum(args), output_leaves=sum(res),
        n_output_leaves=len(res),
        dropped=sum(b for i, b in enumerate(args) if i not in kept),
        flops=analyze_hlo(compiled.as_text(), 8).flops)
json.dump(out, open(dst, "w"))
'''

PORT_BODY = r'''
import json, sys
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_env

cells, shapes, dst = json.loads(sys.argv[1]), json.loads(sys.argv[2]), \
    sys.argv[3]
env = make_env("node")
json.dump({f"{a}/{m}": run_cell(ARCHS[a].reduced(), ShapeConfig(*shapes[m]),
                                env, "node") for a, m in cells},
          open(dst, "w"))
'''

FULL_BODY = r'''
import json, resource, sys
from repro_torch.configs import get_arch, get_shape
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_env

env = make_env("node")
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
rec = run_cell(get_arch("qwen3-moe-235b-a22b"), get_shape("prefill_32k"),
               env, "node")
after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
json.dump({"record": rec, "rss_kib": [before, after]}, open(sys.argv[1], "w"))
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    shapes = {m: [s.name, s.seq_len, s.global_batch, s.kind]
              for m, s in SHAPES.items()}
    def start(*argv, **kw):
        return subprocess.Popen([sys.executable, *argv], env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, **kw)

    half = len(CELLS) // 2
    procs = {
        "jax": start("-c", textwrap.dedent(JAX_BODY), json.dumps(CELLS),
                     json.dumps(shapes), str(tmp / "jax.json")),
        "full": start("-c", textwrap.dedent(FULL_BODY),
                      str(tmp / "full.json")),
        "port0": start("-c", textwrap.dedent(PORT_BODY),
                       json.dumps(CELLS[:half]), json.dumps(shapes),
                       str(tmp / "port0.json")),
        "port1": start("-c", textwrap.dedent(PORT_BODY),
                       json.dumps(CELLS[half:]), json.dumps(shapes),
                       str(tmp / "port1.json")),
        "cli": start("-m", "repro_torch.launch.train", "--arch",
                     "smollm-360m", "--dry", "--shape", "decode_32k",
                     "--out", str(tmp / "cli"), cwd=str(tmp)),
    }
    try:
        logs = {k: p.communicate(timeout=900)[0] for k, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    rcs = {k: p.returncode for k, p in procs.items()}

    def load(name):
        path = tmp / f"{name}.json"
        return json.load(open(path)) if path.exists() else {}

    return dict(port={**load("port0"), **load("port1")}, logs=logs, rcs=rcs,
                jax=load("jax"), full=load("full"), cli=tmp / "cli")


def _check_ran(runs, *keys):
    for key in keys:
        assert runs["rcs"][key] == 0, runs["logs"][key][-3000:]


def _logits_bytes(arch: str, mode: str):
    """(the logits' bytes, one card's (dp, None, tp) piece of them)."""
    cfg = ARCHS[arch].reduced()
    whole = SHAPES[mode].global_batch * cfg.padded_vocab * 4
    return whole, whole // 8


@pytest.mark.parametrize("arch, mode", CELLS)
def test_argument_bytes_match_jax(runs, arch, mode):
    _check_ran(runs, "jax", "port0", "port1")
    j = runs["jax"][f"{arch}/{mode}"]
    by = runs["port"][f"{arch}/{mode}"]["bytes_per_device"][
        "argument_by_device"]
    scalar = 0 if mode == "prefill" else 4     # step / pos on cell 0 only
    assert j["argument"] == j["argument_leaves"] - j["dropped"]
    assert by[0] == j["argument_leaves"]
    assert by[-1] + scalar == j["argument_leaves"]
    # the record's own figure is the busiest card's (the highest peak)
    rec = runs["port"][f"{arch}/{mode}"]["bytes_per_device"]
    peak = rec["peak_by_device"]
    assert max(by) == by[0]
    assert rec["argument"] == by[peak.index(max(peak))]


@pytest.mark.parametrize("arch, mode", CELLS)
def test_output_bytes_match_jax(runs, arch, mode):
    _check_ran(runs, "jax", "port0", "port1")
    j = runs["jax"][f"{arch}/{mode}"]
    by = runs["port"][f"{arch}/{mode}"]["bytes_per_device"][
        "output_by_device"]
    assert j["output"] == j["output_leaves"] + 8 * j["n_output_leaves"]
    if mode == "train":
        first_only = 4 + 4 * 4                   # step, 4 metrics
        assert by[-1] + first_only == j["output_leaves"]
        assert by[0] == by[-1] + first_only
    else:
        whole, piece = _logits_bytes(arch, mode)
        assert by[-1] + piece == j["output_leaves"]
        assert by[0] - whole + piece == j["output_leaves"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_first_card_peak_stays_near_the_others_in_training(runs, arch):
    """The first cell builds no whole leaf, activation or batch input: its
    peak lies within 10% of the busiest other card's."""
    _check_ran(runs, "port0", "port1")
    peak = runs["port"][f"{arch}/train"]["bytes_per_device"][
        "peak_by_device"]
    assert peak[0] <= 1.1 * max(peak[1:])


def _slstm_products(arch: str, mode: str) -> float:
    """One sLSTM scan's products on one card: 2 · hd · 4hd per row, step
    and head of its (B/dp, S/tp) block, for each "s" layer."""
    cfg = ARCHS[arch].reduced()
    shape = SHAPES[mode]
    n_s = sum(k == "s" for k in cfg.layer_kinds())
    hd = cfg.d_model // cfg.n_heads
    rows, steps = shape.global_batch // 2, shape.seq_len // 4
    return n_s * 2.0 * rows * steps * cfg.n_heads * hd * 4 * hd


@pytest.mark.parametrize("arch, mode", CELLS)
def test_flops_match_jax(runs, arch, mode):
    _check_ran(runs, "jax", "port0", "port1")
    want = runs["jax"][f"{arch}/{mode}"]["flops"]
    got = runs["port"][f"{arch}/{mode}"]["op_analysis"]["flops"]
    if mode == "prefill":
        assert got + 7 * _slstm_products(arch, mode) == pytest.approx(
            want, rel=0.03)
    elif mode == "train":
        assert got == pytest.approx(want, rel=0.12)
    else:
        assert got == pytest.approx(want, rel=0.05)


def test_records_hold_every_key(runs):
    _check_ran(runs, "port0", "port1", "full")
    for rec in list(runs["port"].values()) + [runs["full"]["record"]]:
        assert set(KEYS) <= set(rec)
        assert set(BYTE_KEYS) <= set(rec["bytes_per_device"])
        assert set(OP_KEYS) <= set(rec["op_analysis"])
        assert set(ROOF_KEYS) <= set(rec["roofline"])
        assert "unknown_trip_loops" not in rec["op_analysis"]
        assert rec["card"].startswith("NVIDIA H100")
        assert rec["roofline"]["dominant"] in ROOF_KEYS[:3]


def test_train_dry_writes_a_record_per_grid(runs):
    """``launch/train.py --dry`` on smollm-360m at its full width, on both
    grids.  (decode_32k: train_4k at full width takes minutes on the CPU;
    the train cells above run the same spec at reduced width.)"""
    _check_ran(runs, "cli")
    for mesh, n in (("card", 1), ("node", 8)):
        rec = json.load(open(runs["cli"]
                             / f"smollm-360m__decode_32k__{mesh}.json"))
        assert set(KEYS) <= set(rec)
        assert (rec["mesh"], rec["n_devices"], rec["mode"]) == \
            (mesh, n, "decode")
        assert rec["op_analysis"]["kernel_launches"] == {
            "decode_attention": 32 * n}


def test_full_width_cell_costs_no_memory(runs):
    """qwen3-moe-235b-a22b's prefill_32k on the node: 94 layers of 128
    experts over 32 x 32,768 tokens, without raising the process's peak
    RSS by 1 GB (``ru_maxrss`` is in KiB)."""
    _check_ran(runs, "full")
    before, after = runs["full"]["rss_kib"]
    assert after - before < 1 << 20
    rec = runs["full"]["record"]
    assert rec["n_devices"] == 8 and rec["mode"] == "prefill"
    # one flash launch per layer, cell and ring step the causal ring runs
    assert rec["op_analysis"]["kernel_launches"] == {
        "flash_attention": 94 * 2 * (1 + 2 + 3 + 4)}
    assert rec["op_analysis"]["collective_counts"]["all-to-all"] > 0
    assert rec["bytes_per_device"]["peak"] > 80e9 and not rec["fits"]


def test_pick_optimizer_above_the_threshold():
    with FakeTensorMode():
        big = specs.init_params(build_model(get_arch("qwen3-moe-235b-a22b")))
        small = specs.init_params(build_model(get_arch("qwen3-1.7b")))
    assert Model.param_count(big) > specs.ADAFACTOR_THRESHOLD
    assert specs.pick_optimizer(big).name == "adafactor"
    assert specs.pick_optimizer(small).name == "adamw"


def test_make_spec_refuses_full_attention_at_500k():
    with pytest.raises(ValueError, match="skips long_500k"):
        specs.make_spec("qwen3-1.7b", "long_500k", make_env("card"))
