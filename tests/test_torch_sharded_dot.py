"""Weight-stationary products on a grid: ``sharding.sharded_dot``,
``sharded_take`` and ``pieces``, and the grid decode step that uses them.

The helpers are held to the whole product (``x @ w``, ``table[ids]``) at
1e-6 in float32 for every spec a 2-D leaf takes under the train and the
serve profile, with the token rows cut over ``data`` and whole, on (2, 4)
and (2, 2) grids of ``"cpu"``; each cell multiplies by its own piece (the
products' FLOPs add up to the whole product's once, not once a cell).
Then every reduced family's decode step is costed on the "node" grid of
fake cards (``launch/dryrun.py``) under both profiles: it all-gathers no
weight leaf but those ``Model._grid_decode`` names.  An untied
unembedding stays in its pieces in the prefill and the loss too: their
records gather it over no ``model`` axis, and on a (2, 4) grid of
``"cpu"`` the loss's gradient on each piece is one device's gradient cut
by the piece's spec.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.lm import make_batch  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed.sharding import P, MeshEnv  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cost import OpCounter  # noqa: E402
from repro_torch.launch.mesh import make_env  # noqa: E402
from repro_torch.models.model import Model, build_model  # noqa: E402

TOL = 1e-6
GRIDS = {"2x4": [["cpu"] * 4] * 2, "2x2": [["cpu"] * 2] * 2}
# every spec a 2-D weight takes under the train and the serve profile
SPECS = [P(None, None), P(None, "model"), P("model", None),
         P("data", "model")]
# every spec the embedding table takes
TABLE_SPECS = [P("model", "data"), P("model", None), P(None, "data"),
               P(None, None)]
FAMILIES = ("qwen3-1.7b", "qwen3-moe-235b-a22b", "xlstm-1.3b",
            "recurrentgemma-9b", "llava-next-34b", "whisper-tiny")
UNTIED = tuple(a for a in FAMILIES if not ARCHS[a].tie_embeddings)


def _rows(env, x, split):
    """x cut into one tensor per cell: the rows over ``data`` when
    ``split``, whole over ``model``."""
    return sh.shard(x, P("data" if split else None), env)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("spec", SPECS, ids=str)
@pytest.mark.parametrize("split", [True, False], ids=["rows_split",
                                                      "rows_whole"])
def test_sharded_dot_is_the_whole_product(grid, spec, split):
    env = MeshEnv(GRIDS[grid])
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((4, 1, 16), generator=gen)
    w = torch.randn((16, 24), generator=gen)
    xs = _rows(env, x, split)
    with OpCounter() as c:
        ys = sh.sharded_dot(xs, sh.shard(w, spec, env), env,
                            rows_split=split)
    got = sh.unshard(ys, P("data" if split else None), env)
    assert got.shape == (4, 1, 24)
    assert _rel(got, x @ w) < TOL
    # each cell multiplies by its own piece: the products add up to the
    # whole product once (a replicated weight: once a row block)
    assert c.total("flops") == 2.0 * 4 * 16 * 24


def test_sharded_dot_cuts_a_whole_weight_by_its_spec():
    env = MeshEnv(GRIDS["2x4"], profile="serve")
    x, w = torch.randn(2, 8), torch.randn(8, 12)
    ys = sh.sharded_dot(_rows(env, x, True), w, env, rows_split=True,
                        spec=P("model", None))
    assert _rel(sh.unshard(ys, P("data"), env), x @ w) < TOL


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("spec", TABLE_SPECS, ids=str)
@pytest.mark.parametrize("split", [True, False], ids=["rows_split",
                                                      "rows_whole"])
def test_sharded_take_looks_up_the_whole_table(grid, spec, split):
    env = MeshEnv(GRIDS[grid])
    gen = torch.Generator().manual_seed(1)
    table = torch.randn((32, 8), generator=gen)
    ids = torch.randint(0, 32, (4, 1), generator=gen, dtype=torch.int32)
    xs = sh.sharded_take(_rows(env, ids, split), sh.shard(table, spec, env),
                         env, rows_split=split)
    got = sh.unshard(xs, P("data" if split else None), env)
    # only zeros are added to each row: its bits
    assert torch.equal(got, table[ids.long()])


def test_pieces_keeps_sharded_leaves_and_cuts_whole_ones():
    env = MeshEnv(GRIDS["2x4"], profile="serve")
    wo = torch.randn(8, 16)
    cut = sh.shard(torch.randn(16, 8), P(None, "model"), env)
    got = sh.pieces({"attn": {"wo": wo, "wq": cut},
                     "norm1": {"scale": torch.zeros(16)}}, env)
    assert got["attn"]["wq"] is cut
    assert got["attn"]["wo"].spec == ("model", None)   # row-parallel
    assert got["attn"]["wo"][5].shape == (2, 16)
    assert got["attn"]["wo"][5]._base is wo             # a view, no copy
    assert got["norm1"]["scale"].spec == (None,)


@pytest.mark.parametrize("profile", ["train", "serve"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_gathers_no_weight_on_the_node(arch, profile):
    """Costed on the node's fake cards: the decode step's all-gathers read
    pieces of no weight leaf but a "rec" layer's conv taps, the MoE router
    and the head's table over its feature dim (``data``, train profile
    only), where the prefill gathers every layer's weights."""
    cfg = ARCHS[arch].reduced()
    env = make_env("node", profile)
    rec = dryrun.run_cell(cfg, ShapeConfig("decode_small", 32, 4, "decode"),
                          env, "node")
    assert dryrun.stray_decode_gathers(rec) == {}
    gathered = {k.split(" over ")[0] for k in rec["weight_gathers"]}
    head = "embed" if cfg.tie_embeddings else "unembed"
    assert (head in gathered) == (profile == "train")
    assert {p.rsplit("/", 1)[-1] for p in gathered} <= {
        head, *Model.DECODE_GATHERED}
    pre = dryrun.run_cell(cfg, ShapeConfig("prefill_small", 32, 4,
                                           "prefill"), env, "node")
    assert dryrun.stray_decode_gathers(pre)



@pytest.mark.parametrize("profile", ["train", "serve"])
@pytest.mark.parametrize("arch", UNTIED)
def test_prefill_and_loss_gather_no_unembedding_over_model(arch, profile):
    """Costed on the node's fake cards, the prefill and the training step
    read the untied unembedding in its pieces: all-gathered over ``data``
    alone (its feature dim, train profile) or not at all (serve), never
    over ``model``; the embedding is still gathered whole for the
    lookup."""
    cfg = ARCHS[arch].reduced()
    env = make_env("node", profile)
    for mode in ("prefill", "train"):
        rec = dryrun.run_cell(cfg, ShapeConfig(f"{mode}_small", 32, 4, mode),
                              env, "node")
        axes = [key.split(" over ")[1].split("+")
                for key in rec["weight_gathers"]
                if key.split(" over ")[0] == "unembed"]
        assert all("model" not in a for a in axes), (mode, axes)
        assert bool(axes) == (profile == "train"), (mode, axes)
        assert any(key.startswith("embed over ")
                   for key in rec["weight_gathers"]), mode


@pytest.mark.parametrize("profile", ["train", "serve"])
@pytest.mark.parametrize("arch", UNTIED)
def test_loss_gradient_on_the_unembedding_pieces(arch, profile):
    """The loss on a (2, 4) grid of ``"cpu"`` in float32, the untied
    unembedding given as its pieces (leaves of their own; a piece two
    cells share is one tensor): each piece's gradient is one device's
    gradient of the whole table cut by the piece's spec, within 1e-5 of
    the largest."""
    cfg = dataclasses.replace(ARCHS[arch].reduced(), dtype="float32")
    if cfg.is_moe:       # generous capacity: no drops on either side
        cfg = dataclasses.replace(
            cfg, capacity_factor=4.0 * cfg.n_experts / cfg.moe_top_k)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v)
             for k, v in make_batch(cfg, 4, 32, 0, 0).items()}
    env = MeshEnv(GRIDS["2x4"], profile=profile)
    whole = params["unembed"].clone().requires_grad_()
    loss, _ = model.loss({**params, "unembed": whole}, batch)
    (want,) = torch.autograd.grad(loss, [whole])
    cut = sh.own_pieces(sh.pieces({"unembed": params["unembed"]},
                                  env)["unembed"])
    leaf = {id(t): t.detach().clone().requires_grad_() for t in cut}
    pieces = sh.Sharded([leaf[id(t)] for t in cut], cut.spec)
    uniq = list(leaf.values())
    loss, _ = model.loss({**params, "unembed": pieces}, batch, env=env)
    got = dict(zip(map(id, uniq), torch.autograd.grad(loss, uniq)))
    ref = sh.shard(want, pieces.spec, env)
    scale = float(want.abs().max())
    for c, t in enumerate(pieces):
        assert float((got[id(t)] - ref[c]).abs().max()) <= 1e-5 * scale, c
