"""The port's LM sharding rules and whole models on grids of ``"cpu"``.

JAX runs once, in one subprocess with
``--xla_force_host_platform_device_count=8``, on a (2, 4) ("data",
"model") mesh: ``infer_param_specs`` (train and serve profiles),
``batch_specs`` and ``cache_specs`` for every arch's reduced config, and
two reduced models (qwen3-1.7b, qwen3-moe-235b-a22b with its drops) on
the mesh: prefill logits, a decode step and the loss.  The port's rules
must give, leaf for leaf, JAX's spec with the stacked lead entry dropped
(the port keeps per-layer lists).  Then every family's reduced model runs
on a (2, 2) grid (data 2 x sequence 2), and its prefill and decode steps
on (2, 4) grids of the serve and of the train profile, against the port's one-device
model, which ``test_torch_lm.py`` and its siblings hold to JAX: logits,
the caches after the prefill and after 4 decode steps, the loss and its
gradients, at 1e-4 of the largest magnitude; the grid ``Trainer`` over 3
steps of AdamW and of Adafactor (its update on the pieces), masters and
optimizer state; ``generate``.  On a (2, 3) grid, whose 3 ``model``
ranks do not divide 32 tokens, the prefill, the loss and ``generate``
raise ``ValueError`` before any layer runs, as JAX's prefill does on a
(2, 3) mesh of 6 forced devices; with 36 tokens the grid holds one device.
On those (2, 4) grids the decode math that reads no weight (xLSTM's
sLSTM step and mLSTM readout, whisper's cross attention) runs on each
rank's block of heads.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.data.lm import make_batch  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed.sharding import MeshEnv  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train.optim import OptimizerConfig, leaves, unflatten  # noqa: E402
from repro_torch.train.trainer import Trainer, join_tree  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
SPEC_BATCH, SPEC_CACHE = 10, 40     # no reduced config has a dim of 10
JAX_MODELS = ("qwen3-1.7b", "qwen3-moe-235b-a22b")
FAMILIES = ("qwen3-1.7b", "qwen3-moe-235b-a22b", "xlstm-1.3b",
            "recurrentgemma-9b", "llava-next-34b", "whisper-tiny")
GRID22 = MeshEnv([["cpu"] * 2] * 2)
GRID23 = MeshEnv([["cpu"] * 3] * 2)
GRID24 = MeshEnv([["cpu"] * 4] * 2)

JAX_BODY = r'''
import json, sys, dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import ARCHS
from repro.distributed.sharding import (MeshEnv, batch_specs, cache_specs,
                                        infer_param_specs, set_env)
from repro.models.model import build_model

src, dst_json, dst_npz, batch, cache_len, models = (
    sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]),
    int(sys.argv[5]), json.loads(sys.argv[6]))
REFUSED = models[0]
auto = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(auto,) * 2)

def flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, P))[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = [list(e) if isinstance(e, tuple) else e for e in leaf]
    return out

specs = {}
for name, cfg in ARCHS.items():
    cfg = cfg.reduced()
    m = build_model(cfg)
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0))
    caches = jax.eval_shape(lambda: m.init_cache(batch, cache_len))
    for prof in ("train", "serve"):
        env = MeshEnv(mesh=mesh, profile=prof)
        specs[f"{name}/params/{prof}"] = flat(infer_param_specs(shapes, env))
    env = MeshEnv(mesh=mesh)
    specs[f"{name}/cache"] = flat(cache_specs(caches, env, batch))
    from repro.data.lm import make_batch
    b = jax.eval_shape(lambda: make_batch(cfg, 4, 32, 0, 0))
    specs[f"{name}/batch"] = flat(batch_specs(b, env))
json.dump(specs, open(dst_json, "w"))

inp = np.load(src)
out = {}
env = MeshEnv(mesh=mesh)
for name in models:
    cfg = dataclasses.replace(ARCHS[name].reduced(), dtype="float32")
    m = build_model(cfg)
    p = m.init(jax.random.PRNGKey(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        out[f"{name}/p/{key}"] = np.asarray(leaf)
    tokens = jnp.asarray(inp[f"{name}/tokens"])
    labels = jnp.asarray(inp[f"{name}/labels"])
    with mesh, set_env(env):
        lg, c = m.prefill(p, {"tokens": tokens}, env, cache_len=40)
        nxt = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
        lg2, _ = m.decode_step(p, c, nxt, jnp.asarray(32, jnp.int32), env)
        loss, _ = m.loss(p, {"tokens": tokens, "labels": labels}, env)
    out[f"{name}/prefill"] = np.asarray(lg)
    out[f"{name}/decode"] = np.asarray(lg2)
    out[f"{name}/loss"] = np.asarray(loss)

# a (2, 3) mesh of 6 of the devices: its 3 "model" ranks do not divide the
# 32 tokens, and the ring's shard_map refuses them
mesh6 = jax.sharding.Mesh(np.array(jax.devices()[:6]).reshape(2, 3),
                          ("data", "model"))
env6 = MeshEnv(mesh=mesh6)
cfg = dataclasses.replace(ARCHS[REFUSED].reduced(), dtype="float32")
m = build_model(cfg)
p = m.init(jax.random.PRNGKey(0))
try:
    with mesh6, set_env(env6):
        m.prefill(p, {"tokens": jnp.asarray(inp[f"{REFUSED}/tokens"])}, env6,
                  cache_len=40)
    out["refused"] = np.asarray("")
except ValueError as e:
    out["refused"] = np.asarray(str(e))
np.savez(dst_npz, **out)
'''


def _batch(cfg, b=4, s=32):
    return {k: torch.as_tensor(v) for k, v in
            make_batch(cfg, b, s, 0, 0).items()}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grid")
    inp = {}
    for name in JAX_MODELS:
        bt = _batch(ARCHS[name].reduced())
        inp[f"{name}/tokens"] = bt["tokens"].numpy()
        inp[f"{name}/labels"] = bt["labels"].numpy()
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(JAX_BODY),
         str(tmp / "in.npz"), str(tmp / "specs.json"), str(tmp / "out.npz"),
         str(SPEC_BATCH), str(SPEC_CACHE), json.dumps(JAX_MODELS)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    specs = json.load(open(tmp / "specs.json"))
    with np.load(tmp / "out.npz") as got:
        out = {k: got[k] for k in got.files}
    return specs, out


def _norm(spec):
    """A spec as a list of None / axis name / list of names (one-name
    tuples as the name)."""
    out = []
    for e in spec:
        if isinstance(e, (list, tuple)):
            e = list(e)
            e = e[0] if len(e) == 1 else e
        out.append(e)
    return out


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{path}/{k}" if path else k).items()}
    if isinstance(tree, list) and not isinstance(tree, sh.PartitionSpec):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{path}/{i}" if path else str(i))
                .items()}
    return {path: tree}


def _jax_param_path(cfg, path: str):
    """The JAX leaf of a port parameter path, and whether JAX stacks it."""
    parts = path.split("/")
    model = build_model(cfg)
    period = len(cfg.block_pattern)
    if parts[0] == "layers":
        i = int(parts[1])
        kind = model.kinds[i]
        if i < model.n_stacked:
            return "/".join(["stack", f"{i % period}_{kind}"] + parts[2:]), \
                True
        return "/".join(["tail", f"{i - model.n_stacked}_{kind}"]
                        + parts[2:]), False
    if parts[0] in ("enc_layers", "cross_layers"):
        return "/".join([parts[0].replace("layers", "stack")] + parts[2:]), \
            True
    return path, False


def _jax_cache_path(cfg, path: str):
    i, name = path.split("/")
    i = int(i)
    model = build_model(cfg)
    kind = model.kinds[i]
    if name in ("cross_k", "cross_v"):
        return f"enc_kv/{'kv'.index(name[-1])}", True
    if i < model.n_stacked:
        period = len(cfg.block_pattern)
        return f"stack/{i % period}_{kind}/{name}", True
    return f"tail/{i - model.n_stacked}_{kind}/{name}", False


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_jax_with_the_lead_dropped(jax_ref, arch):
    specs, _ = jax_ref
    cfg = ARCHS[arch].reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    for prof in ("train", "serve"):
        env = MeshEnv([["cpu"] * 4] * 2, profile=prof)
        want = specs[f"{arch}/params/{prof}"]
        got = _flat(sh.infer_param_specs(params, env))
        seen = set()
        for path, spec in got.items():
            jpath, stacked = _jax_param_path(cfg, path)
            w = want[jpath]
            seen.add(jpath)
            if stacked:
                assert w[0] is None, (jpath, w)
                w = w[1:]
            assert _norm(spec) == _norm(w), (prof, path, spec, w)
        assert seen == set(want)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_and_cache_specs_match_jax(jax_ref, arch):
    specs, _ = jax_ref
    cfg = ARCHS[arch].reduced()
    model = build_model(cfg)
    got = _flat(sh.batch_specs(_batch(cfg), GRID24))
    want = specs[f"{arch}/batch"]
    assert set(got) == set(want)
    for k in got:
        assert _norm(got[k]) == _norm(want[k]), (k, got[k], want[k])
    caches = model.init_cache(SPEC_BATCH, SPEC_CACHE, "cpu")
    got = _flat(sh.cache_specs(caches, GRID24, SPEC_BATCH))
    want = specs[f"{arch}/cache"]
    for path, spec in got.items():
        jpath, stacked = _jax_cache_path(cfg, path)
        w = want[jpath]
        if stacked:
            assert w[0] is None, (jpath, w)
            w = w[1:]
        assert _norm(spec) == _norm(w), (path, spec, w)


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


@pytest.mark.parametrize("arch", JAX_MODELS)
def test_grid_model_matches_the_jax_model_on_its_mesh(jax_ref, arch):
    """JAX's Model.prefill/decode_step/loss on a forced (2, 4) mesh against
    the port's on a (2, 4) grid of "cpu", the same weights: MoE capacity
    is per cell on both, so the drops match too."""
    _, out = jax_ref
    cfg = dataclasses.replace(ARCHS[arch].reduced(), dtype="float32")
    model = build_model(cfg)
    prefix = f"{arch}/p/"
    params = params_from_jax(cfg, _unflat(
        {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}))
    bt = _batch(cfg)
    with torch.inference_mode():
        lg, caches = model.prefill(params, {"tokens": bt["tokens"]},
                                   cache_len=40, env=GRID24)
        nxt = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
        lg2, _ = model.decode_step(params, caches, nxt, 32, env=GRID24)
    for got, key in ((lg, "prefill"), (lg2, "decode")):
        want = out[f"{arch}/{key}"]
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL * np.abs(want).max())
    loss, _ = model.loss(params, bt, env=GRID24)
    np.testing.assert_allclose(float(loss), float(out[f"{arch}/loss"]),
                               rtol=TOL)


def _f32(arch):
    cfg = dataclasses.replace(ARCHS[arch].reduced(), dtype="float32")
    if cfg.is_moe:       # generous capacity: no drops on either side
        cfg = dataclasses.replace(
            cfg, capacity_factor=4.0 * cfg.n_experts / cfg.moe_top_k)
    return cfg


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / max(float(want.float().abs().max()), 1e-30))


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_on_a_grid_matches_one_device(arch):
    cfg = _f32(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    full = _batch(cfg)
    batch = {k: v for k, v in full.items() if k != "labels"}
    with torch.inference_mode():
        l1, c1 = model.prefill(params, batch, cache_len=40)
        l2, c2 = model.prefill(params, batch, cache_len=40, env=GRID22)
        assert _rel(l2, l1) < TOL
        for step in range(5):
            whole = model.gather_caches(c2, GRID22)
            for i, c in enumerate(c1):
                for k in c:
                    assert _rel(whole[i][k], c[k]) < TOL, (step, i, k)
            if step == 4:
                break
            tok = l1[:, -1].argmax(-1)[:, None].to(torch.int32)
            l1, c1 = model.decode_step(params, c1, tok, 32 + step)
            l2, c2 = model.decode_step(params, c2, tok, 32 + step,
                                       env=GRID22)
            assert _rel(l2, l1) < TOL, step
    grads = []
    for env in (None, GRID22):
        ps = [t.clone().requires_grad_() for t in leaves(params)]
        loss, _ = model.loss(unflatten(params, ps), full, env=env)
        grads.append((loss, torch.autograd.grad(loss, ps)))
    (loss1, g1), (loss2, g2) = grads
    assert abs(float(loss2.detach() - loss1.detach())) < TOL * abs(
        float(loss1.detach()))
    for a, b in zip(g1, g2):
        assert _rel(b, a) < TOL


@pytest.mark.parametrize("arch, profile", [
    pytest.param(a, p, id=a if p == "serve" else f"{a}-{p}")
    for p in ("serve", "train") for a in FAMILIES])
def test_family_decode_on_a_serve_grid_matches_one_device(arch, profile):
    """The prefill and 4 decode steps on a (2, 4) grid, the weights cut
    into their pieces: in the serve profile's layout (Megatron: ``wo``,
    ``w_down`` and ``proj_in`` cut over ``model`` on their contraction dim,
    the other matrices on their output dim, the tables on the vocabulary
    only), where the decode step's row-parallel products add their
    partial sums over ``model``, and in the train profile's.  The decode
    math that reads no weight (the sLSTM step, the mLSTM readout, the
    cross attention) runs on each ``model`` rank's block of the 4 heads.
    The logits and every cache (the states all-gathered back to
    ``cache_specs``' layout) within TOL of one device's, the greedy tokens
    one device's."""
    cfg = _f32(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    env = MeshEnv([["cpu"] * 4] * 2, profile=profile)
    cut = sh.pieces(params, env)
    batch = {k: v for k, v in _batch(cfg).items() if k != "labels"}
    with torch.inference_mode():
        l1, c1 = model.prefill(params, batch, cache_len=40)
        l2, c2 = model.prefill(cut, batch, cache_len=40, env=env)
        assert _rel(l2, l1) < TOL
        for step in range(4):
            tok = l1[:, -1].argmax(-1)[:, None].to(torch.int32)
            l1, c1 = model.decode_step(params, c1, tok, 32 + step)
            l2, c2 = model.decode_step(cut, c2, tok, 32 + step, env=env)
            assert _rel(l2, l1) < TOL, step
            assert torch.equal(l2[:, -1].argmax(-1), l1[:, -1].argmax(-1))
        whole = model.gather_caches(c2, env)
        specs = sh.cache_specs(c1, env, 4)
        for i, c in enumerate(c1):
            for k in c:
                got, want = (tuple(sp) + (None,) * (c[k].dim() - len(sp))
                             for sp in (c2[i][k].spec, specs[i][k]))
                assert got == want, (i, k)
                assert _rel(whole[i][k], c[k]) < TOL, (i, k)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_grid_trainer_follows_the_one_device_trainer(name):
    """3 steps (Adafactor factoring the 64-wide matrices): the masters and
    the state rest as pieces by ``infer_param_specs``, each piece a tensor
    of its own, and the joined masters and state follow one device (the
    masters within TOL: an update's direction amplifies the reordered
    sums of gradients near 0)."""
    cfg = _f32("qwen3-1.7b")
    model = build_model(cfg)
    full = _batch(cfg)
    opt = OptimizerConfig(name=name, factored_min_dim=32)
    one = Trainer(model, opt, device="cpu", seed=0)
    grid = Trainer(model, opt, env=GRID22, seed=0)
    s1, s2 = one.init_state(), grid.init_state()
    wq = s2.params["layers"][0]["attn"]["wq"]
    assert isinstance(wq, sh.Sharded) and wq.spec == ("data", "model")
    assert wq[3].shape == (cfg.d_model // 2, cfg.q_dim // 2)
    assert wq[3].untyped_storage().nbytes() == wq[3].numel() * 4
    s1 = one.fit(s1, iter([full] * 3), 3, log_every=0)
    s2 = grid.fit(s2, iter([full] * 3), 3, log_every=0)
    for a, b in zip(leaves(s1.params), leaves(join_tree(s2.params, GRID22))):
        assert float((a - b).abs().max()) < TOL
    # the moments accumulate the gradients: each leaf within TOL of its
    # largest
    got = leaves(join_tree(s2.opt_state, GRID22))
    assert len(got) == len(leaves(s1.opt_state))
    for a, b in zip(leaves(s1.opt_state), got):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= TOL * float(a.abs().max())


def test_generate_on_a_grid_gives_the_one_device_tokens():
    cfg = _f32("qwen3-1.7b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": _batch(cfg)["tokens"]}
    want = generate(model, params, batch, steps=6, cache_len=40)
    got = generate(model, params, batch, steps=6, cache_len=40, env=GRID22)
    assert torch.equal(got, want)


def test_gather_for_compute_makes_no_copy_on_a_repeated_device():
    """A grid that names one device four times gathers a layer's weights
    once: the whole tensor itself, shared by every cell."""
    p = {"attn": {"wq": torch.randn(8, 12)}, "norm1": {"scale":
                                                       torch.zeros(8)}}
    got = sh.gather_for_compute(p, GRID22)
    assert all(t is p["attn"]["wq"] for t in got["attn"]["wq"])
    assert all(t is p["norm1"]["scale"] for t in got["norm1"]["scale"])
    assert sh.gather_for_compute(p) is p            # no env: the identity


def test_constrain_lays_out_by_logical_names():
    x = torch.randn(4, 6, 8)
    assert sh.constrain(x, "dp", "sp", None) is x   # no env
    env = MeshEnv([["cpu"] * 4] * 2)
    cells = sh.constrain(x, "dp", "sp", None, env=env)
    # 6 does not divide over 4 "model" ranks: the sequence stays whole
    assert cells.spec == ("data", None, None)
    assert cells[0].shape == (2, 6, 8)
    assert sh.logical_spec((4, 8, 6), ("dp", "sp", "tp"), env) == \
        ("data", "model", None)


def test_jax_refuses_a_sequence_model_does_not_divide(jax_ref):
    """JAX's own prefill on a (2, 3) mesh with 32 tokens: the ring's
    ``shard_map`` raises ``ValueError``."""
    _, out = jax_ref
    assert "not evenly divisible" in str(out["refused"])


def _no_embedding(*args, **kw):
    raise AssertionError("the grid embedded a sequence it must refuse")


@pytest.mark.parametrize("entry", ["prefill", "loss", "generate",
                                   "frames"])
def test_grid_refuses_a_sequence_model_does_not_divide(entry, monkeypatch):
    """32 tokens over 3 ``model`` ranks (and whisper's 256 frames, its 36
    tokens dividing): ``ValueError`` naming the argument, its length and
    the axis's size, raised before the tables are gathered or anything is
    embedded."""
    arch = "whisper-tiny" if entry == "frames" else JAX_MODELS[0]
    cfg = _f32(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    bt = _batch(cfg, s=36 if entry == "frames" else 32)
    monkeypatch.setattr(type(model), "_grid_tables", _no_embedding)
    monkeypatch.setattr(type(model), "_grid_embed", _no_embedding)
    name, n = ("frames", bt["frames"].shape[1]) if entry == "frames" \
        else ("tokens", 32)
    with pytest.raises(ValueError, match=f"{name}: a sequence of length "
                       f"{n} is not divisible by the grid's 'model' axis of "
                       f"size 3"):
        if entry == "loss":
            model.loss(params, bt, env=GRID23)
        elif entry == "generate":
            generate(model, params, {"tokens": bt["tokens"]}, steps=2,
                     cache_len=40, env=GRID23)
        else:
            model.prefill(params, {k: v for k, v in bt.items()
                                   if k != "labels"}, cache_len=40,
                          env=GRID23)


def test_grid_holds_one_device_where_model_divides_the_sequence():
    """36 tokens on the same (2, 3) grid: the prefill's logits and caches
    and the loss within TOL of one device's."""
    cfg = _f32(JAX_MODELS[0])
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    bt = _batch(cfg, s=36)
    tokens = {"tokens": bt["tokens"]}
    with torch.inference_mode():
        l1, c1 = model.prefill(params, tokens, cache_len=40)
        l2, c2 = model.prefill(params, tokens, cache_len=40, env=GRID23)
        assert _rel(l2, l1) < TOL
        whole = model.gather_caches(c2, GRID23)
        for i, c in enumerate(c1):
            for k in c:
                assert _rel(whole[i][k], c[k]) < TOL, (i, k)
        loss1, _ = model.loss(params, bt)
        loss2, _ = model.loss(params, bt, env=GRID23)
    assert abs(float(loss2 - loss1)) < TOL * abs(float(loss1))
