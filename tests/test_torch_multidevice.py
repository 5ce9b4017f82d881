"""The port's several-device functions against JAX's ``shard_map``
branches, on grids of ``"cpu"``.

JAX runs once, in one subprocess with
``--xla_force_host_platform_device_count=8`` (as ``test_multidevice.py``
forces its devices), on a (2, 4) ("data", "model") mesh and a
("stage",) mesh of 4; it reads its inputs from an npz that this module
writes from a numpy seed and writes its outputs to another.  The port runs
the same inputs in process on ``MeshEnv`` grids of ``"cpu"``: (2, 4) and
("stage",) x 4.  Tolerances are ``test_multidevice.py``'s: 2e-5 for the
ring, the decode and the pipeline, 3e-4 for the recurrences and MoE.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.distributed.pipeline import (  # noqa: E402
    pipeline_apply, pipeline_bubble)
from repro_torch.distributed.sharding import MeshEnv, shard, unshard  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import recurrent as rec  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = MeshEnv([["cpu"] * 4] * 2)

B, S, H, KVH, HD = 4, 64, 4, 2, 16
S_MEM = 32                       # the cross ring's memory: S_q != S_kv
MOE_CASES = {"generous": (4, 8.0), "drops": (8, 0.5)}   # (E, capacity f.)


def _inputs() -> dict:
    rng = np.random.default_rng(24)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa
    d_moe = ARCHS["qwen3-moe-235b-a22b"].reduced().d_model
    return {
        "q": f(B, S, H, HD), "k": f(B, S, KVH, HD), "v": f(B, S, KVH, HD),
        "mk": f(B, S_MEM, KVH, HD), "mv": f(B, S_MEM, KVH, HD),
        "dq": f(B, 1, H, HD), "kn": f(B, 1, KVH, HD), "vn": f(B, 1, KVH, HD),
        "pw": f(4, 16, 16) * 0.3, "px": f(8, 16),
        "mq": f(B, 32, 2, 8), "mkk": f(B, 32, 2, 8), "mvv": f(B, 32, 2, 8),
        "mi": f(B, 32, 2), "mf": f(B, 32, 2) + 2.0,
        "rx": f(B, 32, 16), "rwrg": f(16, 16) * 0.3, "rwig": f(16, 16) * 0.3,
        "rbrg": f(16), "rbig": f(16), "rcw": f(4, 16) * 0.3, "rcb": f(16),
        "sx": f(B, 32, 4, 2, 8), "sr": f(2, 8, 32) * 8 ** -0.5,
        "xmoe": f(4, 8, d_moe) * 0.1, "xdec": f(4, 1, d_moe) * 0.1,
        "pre_a": rng.uniform(0.5, 1.0, (4, 3)).astype(np.float32),
        "pre_b": f(4, 3),
    }


JAX_BODY = r'''
import json, sys, dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.distributed.sharding import MeshEnv
from repro.models.attention import (ring_attention, cross_attention,
                                    decode_attention)
from repro.models.recurrent import (mlstm_seq, rglru_seq, slstm_seq,
                                    _exclusive_ring_prefix)
from repro.models.moe import moe_init, moe_dispatch, moe_decode
from repro.distributed.pipeline import pipeline_apply
from repro.configs import ARCHS

src, dst, moe_cases = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
x = {k: jnp.asarray(v) for k, v in np.load(src).items()}
auto = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(auto,) * 2)
env = MeshEnv(mesh=mesh)
out = {}
with mesh:
    out["ring"] = ring_attention(x["q"], x["k"], x["v"], env=env)
    out["ring_w24"] = ring_attention(x["q"], x["k"], x["v"], env=env,
                                     window=24)
    out["cross"] = cross_attention(x["q"], x["mk"], x["mv"], env=env)
    def loss(q, k, v):
        return (ring_attention(q, k, v, env=env) ** 2).sum()
    gq, gk, gv = jax.grad(loss, argnums=(0, 1, 2))(x["q"], x["k"], x["v"])
    out["ring_gq"], out["ring_gk"], out["ring_gv"] = gq, gk, gv
    dec = jax.jit(lambda pos: decode_attention(
        x["dq"], x["k"], x["v"], x["kn"], x["vn"], pos, env=env))
    for pos in (40, 5, 63):
        o, kc, vc = dec(jnp.asarray(pos, jnp.int32))
        out[f"dec{pos}"], out[f"dec{pos}_k"] = o, kc
    o, _, _ = decode_attention(x["dq"], x["k"], x["v"], x["kn"], x["vn"],
                               jnp.asarray(40, jnp.int32), env=env,
                               window=24)
    out["dec40_w24"] = o
    out["mlstm"] = mlstm_seq(x["mq"], x["mkk"], x["mvv"], x["mi"], x["mf"],
                             env=env)
    out["rglru"] = rglru_seq(x["rx"], x["rwrg"], x["rbrg"], x["rwig"],
                             x["rbig"], x["rcw"], x["rcb"],
                             jnp.full((16,), 0.7), env=env)
    out["slstm"] = slstm_seq(x["sx"], x["sr"], env=env)
    def prefix(a, b):
        comb = lambda e, l: (e[0] * l[0], l[0] * e[1] + l[1])
        ident = (jnp.ones_like(a), jnp.zeros_like(b))
        pa, pb = _exclusive_ring_prefix((a, b), comb, ident, "model", 4)
        return pa, pb
    pa, pb = jax.shard_map(
        prefix, mesh=mesh, in_specs=(P("model"), P("model")),
        out_specs=(P("model"), P("model")), check_vma=False)(
            x["pre_a"], x["pre_b"])
    out["prefix_a"], out["prefix_b"] = pa, pb
    for name, (e, cf) in moe_cases.items():
        cfg = dataclasses.replace(ARCHS["qwen3-moe-235b-a22b"].reduced(),
                                  n_experts=e, moe_top_k=2,
                                  capacity_factor=cf)
        p = moe_init(cfg, jax.random.PRNGKey(e))
        for k_, v_ in p.items():
            out[f"moe_{name}_{k_}"] = v_
        y, aux = moe_dispatch(cfg, p, x["xmoe"], env=env)
        out[f"moe_{name}_y"], out[f"moe_{name}_aux"] = y, aux
        out[f"moe_{name}_dec"] = moe_decode(cfg, p, x["xdec"], env=env)
smesh = jax.make_mesh((4,), ("stage",), axis_types=(auto,))
senv = MeshEnv(mesh=smesh)
with smesh:
    out["pipe"] = pipeline_apply(lambda w, h: jnp.tanh(h @ w), x["pw"],
                                 x["px"], env=senv, axis="stage", n_micro=4)
np.savez(dst, **{k: np.asarray(v) for k, v in out.items()})
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Inputs and JAX's outputs, from one 8-device JAX subprocess."""
    tmp = tmp_path_factory.mktemp("multidevice")
    x = _inputs()
    np.savez(tmp / "in.npz", **x)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(JAX_BODY),
         str(tmp / "in.npz"), str(tmp / "out.npz"), json.dumps(MOE_CASES)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(tmp / "out.npz") as got:
        out = {k: got[k] for k in got.files}
    return {k: torch.tensor(v) for k, v in x.items()}, out


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("window,key", [(0, "ring"), (24, "ring_w24")])
def test_ring_attention_matches_jax(ref, window, key):
    x, want = ref
    with torch.no_grad():
        got = attn.ring_attention(x["q"], x["k"], x["v"], env=GRID,
                                  window=window)
    _close(got, want[key], 2e-5)


def test_ring_attention_gradients_match_jax(ref):
    x, want = ref
    q, k, v = (x[n].clone().requires_grad_() for n in ("q", "k", "v"))
    out = attn.ring_attention(q, k, v, env=GRID)
    gq, gk, gv = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    for got, key in ((gq, "ring_gq"), (gk, "ring_gk"), (gv, "ring_gv")):
        _close(got, want[key], 2e-5)


def test_cross_attention_ring_matches_jax(ref):
    x, want = ref
    with torch.no_grad():
        got = attn.cross_attention(x["q"], x["mk"], x["mv"], env=GRID)
    _close(got, want["cross"], 2e-5)


@pytest.mark.parametrize("pos", [40, 5, 63])
def test_split_k_decode_matches_jax(ref, pos):
    """pos 5: three shards past pos (no live key); 63: the last shard's
    last slot."""
    x, want = ref
    kc, vc = x["k"].clone(), x["v"].clone()
    out, kc2, _ = attn.decode_attention(x["dq"], kc, vc, x["kn"], x["vn"],
                                        pos, env=GRID)
    _close(out, want[f"dec{pos}"], 2e-5)
    np.testing.assert_array_equal(kc2.numpy(), want[f"dec{pos}_k"])
    assert not torch.isnan(out).any()


def test_split_k_decode_with_a_window_matches_jax(ref):
    x, want = ref
    out, _, _ = attn.decode_attention(x["dq"], x["k"].clone(),
                                      x["v"].clone(), x["kn"], x["vn"], 40,
                                      env=GRID, window=24)
    _close(out, want["dec40_w24"], 2e-5)


def test_pipeline_matches_jax(ref):
    x, want = ref
    env = MeshEnv(("cpu",) * 4, axis_names=("stage",))
    got = pipeline_apply(lambda w, h: torch.tanh(h @ w), x["pw"], x["px"],
                         env=env, axis="stage", n_micro=4)
    _close(got, want["pipe"], 2e-5)
    assert pipeline_bubble(4, 4) == pytest.approx(3 / 7)


def test_mlstm_matches_jax(ref):
    x, want = ref
    got = rec.mlstm_seq(x["mq"], x["mkk"], x["mvv"], x["mi"], x["mf"],
                        env=GRID)
    _close(got, want["mlstm"], 3e-4)


def test_rglru_matches_jax(ref):
    x, want = ref
    got = rec.rglru_seq(x["rx"], x["rwrg"], x["rbrg"], x["rwig"],
                        x["rbig"], x["rcw"], x["rcb"],
                        torch.full((16,), 0.7), env=GRID)
    _close(got, want["rglru"], 3e-4)


def test_slstm_carry_chain_matches_jax(ref):
    x, want = ref
    got = rec.slstm_seq(x["sx"], x["sr"], env=GRID)
    _close(got, want["slstm"], 3e-4)
    # the training form runs the same chain
    _close(rec.slstm_train(x["sx"], x["sr"], env=GRID), want["slstm"], 3e-4)


def test_exclusive_ring_prefix_matches_jax(ref):
    """An affine segment (a, b) per rank composed in rank order against
    JAX's Hillis–Steele doubling over ``ppermute``."""
    x, want = ref
    env = MeshEnv([["cpu"] * 4])
    summ = [(x["pre_a"][r:r + 1], x["pre_b"][r:r + 1]) for r in range(4)]
    got = rec._exclusive_ring_prefix(
        summ, lambda e, l: (e[0] * l[0], l[0] * e[1] + l[1]),
        lambda s: (torch.ones_like(s[0]), torch.zeros_like(s[1])), env)
    _close(torch.cat([g[0] for g in got]), want["prefix_a"], 1e-6)
    _close(torch.cat([g[1] for g in got]), want["prefix_b"], 1e-6)


def _moe(name, want):
    import dataclasses
    e, cf = MOE_CASES[name]
    cfg = dataclasses.replace(ARCHS["qwen3-moe-235b-a22b"].reduced(),
                              n_experts=e, moe_top_k=2, capacity_factor=cf)
    p = {k: torch.tensor(want[f"moe_{name}_{k}"]) for k in
         ("router", "expert_w_gate", "expert_w_up", "expert_w_down")}
    return cfg, p


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_dispatch_matches_jax(ref, name):
    """Capacity is per cell: with drops ("drops", cf 0.5) the grid's result
    is JAX's on the same grid, not the one-device one."""
    x, want = ref
    cfg, p = _moe(name, want)
    y, aux = moe.moe_dispatch(cfg, p, x["xmoe"], env=GRID)
    _close(y, want[f"moe_{name}_y"], 3e-4)
    _close(aux, want[f"moe_{name}_aux"], 3e-4)
    y1, _ = moe.moe_dispatch(cfg, p, x["xmoe"])
    dropped = not np.allclose(y1.numpy(), want[f"moe_{name}_y"], atol=3e-4)
    assert dropped == (name == "drops")


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_decode_matches_jax(ref, name):
    x, want = ref
    cfg, p = _moe(name, want)
    got = moe.moe_decode(cfg, p, x["xdec"], env=GRID)
    _close(got, want[f"moe_{name}_dec"], 3e-4)


def test_shard_and_unshard_round_trip_without_copies():
    """On a grid that repeats one device a piece is a view, and joining the
    views gives back the tensor itself."""
    t = torch.arange(4 * 8 * 3, dtype=torch.float32).reshape(4, 8, 3)
    cells = shard(t, ("data", "model"), GRID)
    assert len(cells) == 8 and cells[5].shape == (2, 2, 3)
    assert torch.equal(cells[5], t[2:4, 2:4])
    assert cells[5].data_ptr() == t[2:4, 2:4].data_ptr()
    back = unshard(cells, None, GRID)
    assert back.data_ptr() == t.data_ptr() and torch.equal(back, t)
    copies = [c.clone() for c in cells]
    assert torch.equal(unshard(copies, ("data", "model"), GRID), t)
