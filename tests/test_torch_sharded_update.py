"""The grid update on pieces (``build_optimizer(..., env=)``) against JAX.

The same numpy parameters, gradients and optimizer state (drawn from a
seed in JAX's stacked layout, for the reduced qwen3-moe-235b-a22b: a
stacked group of 2 layers, expert tensors cut 3 ways, ≥2-D leaves cut
over ("data", "model"), replicated 1-D norms, and with
``factored_min_dim`` lowered to 32 so that the narrow ``wk`` (64, 32)
factors) go through JAX's ``build_optimizer(cfg)[1]`` on the whole
arrays and through the port's update on ``Sharded`` pieces on a (2, 4)
grid of ``"cpu"``, for 3 steps of AdamW and of Adafactor.  The joined
masters, the joined state and ``grad_norm`` lie within 1e-6 of each
leaf's largest of JAX's; on a grid of one cell every output equals the
port's one-device update bit for bit.  On the dry run's fake node of 8
distinct devices, no output piece of a sharded leaf is a whole leaf or a
view of one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.train.optim import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.train.optim import build_optimizer as jax_build_optimizer  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed.sharding import MeshEnv  # noqa: E402
from repro_torch.launch.mesh import make_env  # noqa: E402
from repro_torch.models.convert import (opt_state_from_jax,  # noqa: E402
                                        params_from_jax)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train.optim import (OptimizerConfig,  # noqa: E402
                                     build_optimizer, leaves, tree_map)
from repro_torch.train.trainer import join_tree, shard_tree  # noqa: E402

ARCH = "qwen3-moe-235b-a22b"
GRID = MeshEnv([["cpu"] * 4] * 2)
ONE_CELL = MeshEnv([["cpu"]])
TOL = 1e-6
OPTIMIZERS = ("adamw", "adafactor")


def _kw(name):
    return dict(name=name, lr=1e-2, warmup_steps=2, factored_min_dim=32)


def _draws(name, seed=5):
    """JAX's parameters, its initial state and 3 gradient trees, numpy
    leaves drawn from ``seed`` (the gradients' norm is ~100: the clip at
    1.0 is active)."""
    rng = np.random.default_rng(seed)
    cfg = JAX_ARCHS[ARCH].reduced()
    shapes = jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0))

    def draw(scale):
        return jax.tree.map(lambda s: (rng.normal(size=s.shape) * scale)
                            .astype(np.float32), shapes)

    params = draw(1.0)
    state = jax_build_optimizer(JaxOptimizerConfig(**_kw(name)))[0](
        jax.tree.map(jnp.asarray, params))
    if name == "adafactor":     # a state that is not zero: its layout shows
        state = jax.tree.map(lambda x: jnp.asarray(
            np.abs(rng.normal(size=x.shape)).astype(np.float32)), state)
    return params, state, [draw(0.3 * (i + 1)) for i in range(3)]


def _jax_run(name, params, state, grads):
    """JAX's update over the gradients: [(params, state, gnorm)] a step,
    numpy leaves."""
    update = jax_build_optimizer(JaxOptimizerConfig(**_kw(name)))[1]
    p, s = jax.tree.map(jnp.asarray, params), state
    out = []
    for i, g in enumerate(grads):
        p, s, gn = update(jax.tree.map(jnp.asarray, g), s, p,
                          jnp.asarray(i, jnp.int32))
        out.append((jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s),
                    float(gn)))
    return out


def _port(name, params, state, grads):
    cfg = get_arch(ARCH).reduced()
    return (cfg, build_model(cfg), params_from_jax(cfg, params),
            opt_state_from_jax(cfg, name, jax.tree.map(np.asarray, state)),
            [params_from_jax(cfg, g) for g in grads])


def _close(got, want):
    assert len(leaves(got)) == len(leaves(want))
    for a, b in zip(leaves(got), leaves(want)):
        b = b.numpy()
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL,
                                   atol=TOL * max(float(np.abs(b).max()),
                                                  1e-30))


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_update_on_pieces_matches_jax(name):
    params, state, grads = _draws(name)
    want = _jax_run(name, params, state, grads)
    cfg, model, tp, ts, tgs = _port(name, params, state, grads)
    update = build_optimizer(OptimizerConfig(**_kw(name)),
                             model.jax_stacks(tp), env=GRID)[1]
    p, s = shard_tree(tp, GRID), shard_tree(ts, GRID)
    wq = p["layers"][0]["attn"]["wq"]
    assert wq.spec == ("data", "model") and len({id(t) for t in wq}) == 8
    assert p["layers"][0]["moe"]["expert_w_gate"].spec == (
        "model", None, "data")
    assert len({id(t) for t in p["final_norm"]}) == 1
    if name == "adafactor":     # the narrow leaf factors
        assert len(s["s"]["layers"][0]["attn"]["wk"]) == 2
    for i, g in enumerate(grads):
        p, s, gn = update(shard_tree(tgs[i], GRID), s, p,
                          torch.tensor(i, dtype=torch.int32))
        jp, js, jgn = want[i]
        np.testing.assert_allclose(float(gn), jgn, rtol=TOL)
        assert gn.dim() == 0
        _close(join_tree(p, GRID), params_from_jax(cfg, jp))
        _close(join_tree(s, GRID), opt_state_from_jax(cfg, name, js))


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_one_cell_grid_keeps_the_one_device_bits(name):
    params, state, grads = _draws(name, seed=9)
    _, model, tp, ts, tgs = _port(name, params, state, grads)
    opt = OptimizerConfig(**_kw(name))
    one = build_optimizer(opt, model.jax_stacks(tp))[1]
    cell = build_optimizer(opt, model.jax_stacks(tp), env=ONE_CELL)[1]
    # shard_tree replaces the leaves of the tree it is given
    p1, s1 = tree_map(torch.clone, tp), tree_map(torch.clone, ts)
    p2, s2 = shard_tree(tp, ONE_CELL), shard_tree(ts, ONE_CELL)
    for i, g in enumerate(tgs):
        step = torch.tensor(i, dtype=torch.int32)
        p1, s1, gn1 = one(tree_map(torch.clone, g), s1, p1, step)
        p2, s2, gn2 = cell(shard_tree(g, ONE_CELL), s2, p2, step)
        assert torch.equal(gn1, gn2)
        for a, b in zip(leaves(p1) + leaves(s1),
                        leaves(join_tree(p2, ONE_CELL))
                        + leaves(join_tree(s2, ONE_CELL))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_no_output_piece_is_a_whole_leaf_on_distinct_devices(name):
    """The fake node (8 distinct ``meta`` devices, shapes only): each
    output piece of a leaf cut over the grid holds its part only, in a
    storage of its own, and sits on its cell's device."""
    env = make_env("node")
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg)
    opt = OptimizerConfig(**_kw(name))
    with FakeTensorMode():
        params = model.init(torch.Generator().manual_seed(0))
        state = build_optimizer(opt)[0](params)
        grads = model.init(torch.Generator().manual_seed(1))
        update = build_optimizer(opt, model.jax_stacks(params), env=env)[1]
        p, s = shard_tree(params, env), shard_tree(state, env)
        new_p, new_s, gn = update(shard_tree(grads, env), s, p,
                                  torch.zeros((), dtype=torch.int32,
                                              device=env.first))
        assert gn.device == env.first
        checked = 0
        for leaf in leaves(new_p) + leaves(new_s):
            whole = sh.whole_shape(leaf, env)
            for c, t in enumerate(leaf):
                assert t.device == env.cells[c]
                assert t.untyped_storage().nbytes() == \
                    t.numel() * t.element_size()
                if any(n > 1 for n in (env.size(sh._axes(e))
                                       for e in leaf.spec)):
                    assert tuple(t.shape) != whole
                    checked += 1
        assert checked > 0
