"""The port's LM training path against the JAX package's, on the CPU.

The reduced float32 configs of every arch: the JAX model's weights are
carried over with ``params_from_jax`` and both packages get the same
numpy batch from the JAX ``make_batch`` (the two packages' streams
differ).  Tolerances, against the JAX tests' 1e-4 in float32:
  * ``Model.loss`` at 1e-4 (abs and rel) and every gradient leaf at
    rtol 1e-4 plus 1e-4 of the leaf's largest magnitude (measured: ≤ 6e-6
    of it), against ``jax.value_and_grad(model.loss)``;
  * ``remat=True`` and ``remat=False``: the same bits (the recompute runs
    the same ops);
  * ``ring_attention`` and its gradients against JAX's
    ``flash_attention_local`` at 1e-5 in float32 (S spanning three
    512-key chunks; causal, windowed, bidirectional, cross), and at 2e-2
    in bfloat16 (the JAX tests' bf16 tolerance);
  * the sLSTM step loop and ``moe_dispatch`` (with and without drops),
    values and gradients, at 1e-5;
  * AdamW and Adafactor (factored and not) against JAX's ``update`` over
    3 steps from the same numpy state and gradients at 1e-6;
  * ``make_train_step`` against JAX's over 3 steps (smollm-360m,
    recurrentgemma-9b with its unstacked tail, whisper-tiny with its
    stacked encoder and cross layers; both optimizers): loss and grad
    norm at 1e-4, parameters at 1e-4 absolute — Adam's direction
    g / (|g| + eps) turns float32 reordering of gradients of size ~eps
    into steps of up to ~lr/10 (measured 8.7e-6 at lr 1e-3);
and JAX's own train smoke check (``tests/test_arch_smoke.py``) on the
port's weights for every arch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.data.lm import make_batch as jax_make_batch  # noqa: E402
from repro.distributed.sharding import set_env, single_device_env  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.train.optim import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.train.optim import build_optimizer as jax_build_optimizer  # noqa: E402
from repro.train.trainer import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.data.lm import make_batch  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402
from repro_torch.models.convert import (opt_state_from_jax,  # noqa: E402
                                        params_from_jax)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import (OptimizerConfig, build_optimizer,  # noqa: E402
                               make_train_step)
from repro_torch.train.optim import leaves, tree_map, unflatten  # noqa: E402

ALL_ARCHS = sorted(ARCHS)
TOL = 1e-4
RNG = np.random.default_rng(23)


@pytest.fixture(scope="module")
def env():
    return single_device_env()


def _t(x, requires_grad=False):
    t = torch.from_numpy(np.array(np.asarray(x), copy=True))
    return t.requires_grad_() if requires_grad else t


def _port_batch(batch):
    return {k: _t(v) for k, v in batch.items()}


def _close_tree(got, want, tol=TOL):
    assert len(leaves(got)) == len(leaves(want))
    for a, b in zip(leaves(got), leaves(want)):
        b = b.detach().numpy()
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=tol,
                                   atol=tol * max(float(np.abs(b).max()),
                                                  1e-30))


def _grads(model, params, batch, remat=True):
    p = tree_map(lambda x: x.detach().clone().requires_grad_(), params)
    loss, metrics = model.loss(p, batch, remat=remat)
    g = torch.autograd.grad(loss, leaves(p))
    return loss.detach(), metrics, unflatten(p, list(g))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_and_every_gradient_match_jax(arch, env):
    cfg = JAX_ARCHS[arch].reduced()
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    batch = jax_make_batch(cfg, 2, 32, seed=0, cursor=0)
    with set_env(env):
        (jl, jmet), jg = jax.jit(jax.value_and_grad(
            lambda p: jm.loss(p, batch, env), has_aux=True))(jp)
    tcfg = get_arch(arch).reduced()
    tm = build_model(tcfg)
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    loss, metrics, grads = _grads(tm, tp, _port_batch(batch))
    for got, want in ((loss, jl), (metrics["nll"], jmet["nll"]),
                      (metrics["aux"], jmet["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=TOL, atol=TOL)
    _close_tree(grads, params_from_jax(tcfg, jax.tree.map(np.asarray, jg)))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_remat_changes_no_bit_of_the_loss_or_gradients(arch):
    cfg = get_arch(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    batch = make_batch(cfg, 2, 32, 1, 0)
    a = _grads(model, params, batch, remat=True)
    b = _grads(model, params, batch, remat=False)
    assert torch.equal(a[0], b[0])
    for x, y in zip(leaves(a[2]), leaves(b[2])):
        assert torch.equal(x, y)


ATTN_CASES = {
    # name: (Sq, Sk, causal, window)
    "causal": (1536, 1536, True, 0),
    "window": (1536, 1536, True, 700),
    "bidirectional": (1536, 1536, False, 0),
    "cross": (96, 1536, False, 0),
}


def _attn_case(sq, sk, dtype):
    b, h, kvh, hd = 2, 4, 2, 16
    q = RNG.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = RNG.normal(size=(b, sk, kvh, hd)).astype(np.float32)
    v = RNG.normal(size=(b, sk, kvh, hd)).astype(np.float32)
    ct = RNG.normal(size=(b, sq, h, hd)).astype(np.float32)
    if dtype == "bfloat16":
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16)
                              .astype(jnp.float32)) for x in (q, k, v))
    return q, k, v, ct


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_ring_attention_and_its_gradients_match_jax_flash(case, dtype, tol):
    sq, sk, causal, window = ATTN_CASES[case]
    q, k, v, ct = _attn_case(sq, sk, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def jfn(q, k, v):
        return jattn.flash_attention_local(
            q, k, v, jnp.arange(sq), jnp.arange(sk), causal=causal,
            window=window).astype(jnp.float32)

    jout, vjp = jax.vjp(jfn, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(ct))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (_t(x).to(tdt).requires_grad_() for x in (q, k, v))
    out = tattn.ring_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == tdt
    grads = torch.autograd.grad(out.float(), (tq, tk, tv), _t(ct))
    for got, want in [(out, jout), *zip(grads, jgrads)]:
        want = np.asarray(jnp.asarray(want, jnp.float32))
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=tol,
                                   atol=tol * float(np.abs(want).max()))


def test_ring_attention_keeps_jaxs_chunking():
    for n in (32, 512, 1536, 1000, 1031, 4096):
        assert tattn._pick_chunk(n, 512) == jattn._pick_chunk(n, 512)


def test_slstm_train_matches_jax_values_and_gradients():
    b, s, h, hd = 2, 12, 2, 8
    xpre = RNG.normal(size=(b, s, 4, h, hd)).astype(np.float32)
    r = (RNG.normal(size=(h, hd, 4 * hd)) * hd ** -0.5).astype(np.float32)
    ct = RNG.normal(size=(b, s, h, hd)).astype(np.float32)

    def jfn(xpre, r):
        z = jnp.zeros((b, h, hd), jnp.float32)
        st = (z, z, z, jnp.full((b, h, hd), -1e30, jnp.float32))
        return jrec._slstm_local_scan(xpre, r, st)[0]

    jout, vjp = jax.vjp(jfn, jnp.asarray(xpre), jnp.asarray(r))
    jgrads = vjp(jnp.asarray(ct))
    tx, tr = _t(xpre, True), _t(r, True)
    out = trec.slstm_train(tx, tr)
    grads = torch.autograd.grad(out, (tx, tr), _t(ct))
    for got, want in [(out, jout), *zip(grads, jgrads)]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("arch,capacity_factor", [
    ("qwen3-moe-235b-a22b", None), ("qwen3-moe-235b-a22b", 0.5),
    ("llama4-scout-17b-a16e", None), ("llama4-scout-17b-a16e", 0.5)])
def test_moe_dispatch_gradients_match_jax(arch, capacity_factor, env):
    """Gradients of sum(y · ct) + 3 · aux reach x, the router (through the
    gates and the aux loss) and every expert as ``jax.grad`` gives them,
    pairs dropped past capacity included.  The router's at 1e-4 of its
    largest magnitude: with top-1 the gate is p / p, whose gradient
    1/p - p/p² cancels, and both packages' float32 router gradients lie
    up to 3.2e-5 of it off the port's float64 one."""
    import dataclasses
    cfg = JAX_ARCHS[arch].reduced()
    tcfg = get_arch(arch).reduced()
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor)
    p = jax.tree.map(np.asarray, jmoe.moe_init(cfg, jax.random.PRNGKey(3)))
    x = RNG.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    ct = RNG.normal(size=x.shape).astype(np.float32)

    def jfn(p, x):
        y, aux = jmoe.moe_dispatch(cfg, p, x, env=env)
        return jnp.sum(y * ct) + 3.0 * aux

    jval, jgrads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = {k: _t(v, True) for k, v in p.items()}
    tx = _t(x, True)
    y, aux = moe.moe_dispatch(tcfg, tp, tx)
    val = torch.sum(y * _t(ct)) + 3.0 * aux
    names = sorted(tp)
    grads = torch.autograd.grad(val, [tp[k] for k in names] + [tx])
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    for name, got, want in zip(names + ["x"], grads,
                               [jgrads[0][k] for k in names] + [jgrads[1]]):
        want = np.asarray(want)
        tol = 1e-4 if name == "router" else 1e-5
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=tol * float(np.abs(want).max()))


def _opt_trees():
    shapes = {"w": (16, 32), "b": (8,), "stack": {"u": (3, 24, 20)},
              "tail": [(20, 6), (6,)]}

    def draw(s, scale):
        if isinstance(s, dict):
            return {k: draw(v, scale) for k, v in s.items()}
        if isinstance(s, list):
            return [draw(v, scale) for v in s]
        return (RNG.normal(size=s) * scale).astype(np.float32)

    return draw(shapes, 1.0), [draw(shapes, 0.3) for _ in range(3)]


@pytest.mark.parametrize("name,min_dim", [("adamw", 128),
                                          ("adafactor", 128),
                                          ("adafactor", 8)])
def test_optimizers_match_jax_update_over_three_steps(name, min_dim):
    """From the same numpy parameters, state and gradients, 3 updates
    (warmup 2, clipping at 1.0 active: the gradients' norm is ~5)."""
    params, grads = _opt_trees()
    kw = dict(name=name, lr=1e-2, warmup_steps=2, factored_min_dim=min_dim)
    jinit, jupdate = jax_build_optimizer(JaxOptimizerConfig(**kw))
    init, update = build_optimizer(OptimizerConfig(**kw))
    jp = jax.tree.map(jnp.asarray, params)
    js = jinit(jp)
    tp = tree_map(_t, params)
    ts = init(tp)
    if name == "adafactor" and min_dim == 8:
        assert len(ts["s"]["w"]) == 2 and len(ts["s"]["b"]) == 1
    for i, g in enumerate(grads):
        jp, js, jgn = jupdate(jax.tree.map(jnp.asarray, g), js, jp,
                              jnp.asarray(i, jnp.int32))
        tp, ts, tgn = update(tree_map(_t, g), ts, tp,
                             torch.tensor(i, dtype=torch.int32))
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
        _close_tree(tp, tree_map(_t, jax.tree.map(np.asarray, jp)), 1e-6)
        _close_tree(ts, tree_map(_t, jax.tree.map(np.asarray, js)), 1e-6)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    from repro.train.optim import clip_by_global_norm as jax_clip
    from repro_torch.train.optim import clip_by_global_norm
    _, grads = _opt_trees()
    jg, jn = jax_clip(jax.tree.map(jnp.asarray, grads[0]), max_norm)
    tg, tn = clip_by_global_norm(tree_map(_t, grads[0]), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _close_tree(tg, tree_map(_t, jax.tree.map(np.asarray, jg)), 1e-6)


def test_update_is_functional_and_reads_nothing_back():
    """``update`` leaves its arguments as they were; step stays a tensor."""
    params, grads = _opt_trees()
    init, update = build_optimizer(OptimizerConfig(lr=1e-2))
    tp = tree_map(_t, params)
    before = [x.clone() for x in leaves(tp)]
    ts = init(tp)
    new_p, new_s, gn = update(tree_map(_t, grads[0]), ts, tp,
                              torch.zeros((), dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(tp)))
    assert all(float(x.abs().sum()) == 0 for x in leaves(ts))
    assert isinstance(gn, torch.Tensor) and gn.dim() == 0


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_jax_stacks_give_jaxs_leaves(arch):
    """Each group of ``Model.jax_stacks`` is one JAX leaf: stacked groups
    have JAX's shape (layers, ...), the rest the leaf's own."""
    cfg = JAX_ARCHS[arch].reduced()
    jshapes = sorted(tuple(np.shape(x)) for x in jax.tree.leaves(
        jax.eval_shape(jax_build_model(cfg).init, jax.random.PRNGKey(0))))
    tcfg = get_arch(arch).reduced()
    model = build_model(tcfg)
    flat = leaves(model.init(torch.Generator().manual_seed(0)))
    shapes = sorted(((len(idx),) if stacked else ()) + tuple(flat[idx[0]].shape)
                    for idx, stacked in model.jax_stacks(
                        model.init(torch.Generator().manual_seed(0))))
    assert shapes == jshapes


@pytest.mark.parametrize("arch,name", [
    ("smollm-360m", "adamw"), ("smollm-360m", "adafactor"),
    ("recurrentgemma-9b", "adamw"), ("recurrentgemma-9b", "adafactor"),
    ("whisper-tiny", "adamw")])
def test_make_train_step_matches_jax_over_three_steps(arch, name, env):
    kw = dict(name=name, lr=1e-3, warmup_steps=2, factored_min_dim=16)
    cfg = JAX_ARCHS[arch].reduced()
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jo = jax_build_optimizer(JaxOptimizerConfig(**kw))[0](jp)
    jstep = jax.jit(jax_make_train_step(jm, JaxOptimizerConfig(**kw), env))
    tcfg = get_arch(arch).reduced()
    tm = build_model(tcfg)
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    to = opt_state_from_jax(tcfg, name, jax.tree.map(np.asarray, jo))
    tstep = make_train_step(tm, OptimizerConfig(**kw))
    js = jnp.zeros((), jnp.int32)
    ts = torch.zeros((), dtype=torch.int32)
    for i in range(3):
        batch = jax_make_batch(cfg, 2, 32, seed=0, cursor=i)
        jp, jo, js, jmet = jstep(jp, jo, js, batch)
        tp, to, ts, tmet = tstep(tp, to, ts, _port_batch(batch))
        assert int(ts) == int(js) == i + 1
        for key in ("loss", "grad_norm", "nll", "aux"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=TOL, atol=TOL)
        want = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
        for a, b in zip(leaves(tp), leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=TOL)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step_smoke(arch):
    """JAX's ``test_train_step_smoke`` on the port: one step from the
    port's own weights gives a finite loss, step 1 and moved parameters;
    three more steps on the same batch lower the loss (memorisation)."""
    cfg = get_arch(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=2)
    opt_state = build_optimizer(opt_cfg)[0](params)
    step_fn = make_train_step(model, opt_cfg, remat=False)
    batch = make_batch(cfg, 2, 32, 0, 0)
    p2, o2, step, metrics = step_fn(params, opt_state,
                                    torch.zeros((), dtype=torch.int32), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert int(step) == 1 and step.dtype == torch.int32
    assert any(not torch.allclose(a, b)
               for a, b in zip(leaves(params), leaves(p2)))
    p, o, s = p2, o2, step
    first = float(metrics["loss"])
    for _ in range(3):
        p, o, s, metrics = step_fn(p, o, s, batch)
    assert float(metrics["loss"]) < first


def test_bf16_training_keeps_float32_masters_and_state():
    """A bf16 config differentiates its bf16 copies and updates float32
    masters: every parameter and optimizer leaf stays float32."""
    import dataclasses
    cfg = dataclasses.replace(get_arch("qwen3-1.7b").reduced(),
                              dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=2)
    opt_state = build_optimizer(opt_cfg)[0](params)
    p2, o2, _, metrics = make_train_step(model, opt_cfg)(
        params, opt_state, torch.zeros((), dtype=torch.int32),
        make_batch(cfg, 2, 32, 0, 0))
    assert np.isfinite(float(metrics["loss"]))
    assert all(x.dtype == torch.float32
               for x in leaves(p2) + leaves(o2))


def test_kernel_inputs_that_require_grad_are_refused():
    """The check every CUDA wrapper runs on its inputs: a tensor that
    requires grad raises while grad mode is on (a kernel's output has no
    ``grad_fn``), and passes under ``torch.no_grad()``."""
    t = torch.zeros(4, requires_grad=True)
    with pytest.raises(ValueError, match="ring_attention"):
        common.require_cuda("q", t, t.device)
    with torch.no_grad():
        common.require_cuda("q", t, t.device)
    common.require_cuda("q", t.detach(), t.device)
