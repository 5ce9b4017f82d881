"""The port's optimizers and gradient-compression codecs.

Mirrors ``tests/test_optim_compression.py`` on the port (both optimizers
minimise a quadratic, Adafactor's state is factored, the int8 codec's
error is bounded, top-k keeps the largest, error feedback converges),
holds the codecs and a one-rank ``compressed_psum`` to JAX's (JAX's
inside a one-device ``shard_map``; the same bits expected: the same
float32 operations in the same order), and checks the several-rank sum
that the port runs over a list of per-rank tensors with ``all_reduce``
against its definition in numpy (int8 payloads summed exactly in int32
against the largest scale).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.distributed import compression as jcomp  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    CompressionConfig, compressed_psum, int8_decode, int8_encode,
    topk_sparsify, tree_compressed_psum)
from repro_torch.train.optim import (OptimizerConfig,  # noqa: E402
                                     build_optimizer)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_minimizes_quadratic(name):
    cfg = OptimizerConfig(name=name, lr=0.15, warmup_steps=1,
                          weight_decay=0.0, factored_min_dim=4)
    init, update = build_optimizer(cfg)
    params = {"w": torch.full((8, 8), 5.0), "b": torch.full((8,), -3.0)}
    state = init(params)

    def loss(p):
        return (p["w"] ** 2).sum() + (p["b"] ** 2).sum()

    l0 = float(loss(params))
    for i in range(80):
        grads = {k: 2 * v for k, v in params.items()}
        params, state, _ = update(grads, state, params,
                                  torch.tensor(i, dtype=torch.int32))
    assert float(loss(params)) < 0.05 * l0


def test_adafactor_state_is_factored():
    init, _ = build_optimizer(OptimizerConfig(name="adafactor",
                                              factored_min_dim=8))
    st = init({"big": torch.zeros((16, 32)), "small": torch.zeros((4,))})
    assert len(st["s"]["big"]) == 2                       # (vr, vc)
    assert st["s"]["big"][0].shape == (16,)
    assert st["s"]["big"][1].shape == (32,)
    assert len(st["s"]["small"]) == 1                     # full v


def test_int8_codec_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(256,))
                         .astype(np.float32))
    q, scale = int8_encode(x)
    y = int8_decode(q, scale)
    assert q.dtype == torch.int8
    assert float((x - y).abs().max()) <= float(scale) * 0.5 + 1e-7


def test_topk_keeps_largest():
    x = torch.tensor([0.1, -5.0, 0.2, 3.0, -0.05, 0.0])
    nz = torch.nonzero(topk_sparsify(x, 2 / 6)).reshape(-1).tolist()
    assert set(nz) == {1, 3}


def test_codecs_give_jaxs_bits():
    x = np.random.default_rng(2).normal(size=(7, 33)).astype(np.float32)
    q, s = int8_encode(torch.from_numpy(x))
    jq, js = jcomp.int8_encode(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(int8_decode(q, s).numpy(),
                                  np.asarray(jcomp.int8_decode(jq, js)))
    np.testing.assert_array_equal(
        topk_sparsify(torch.from_numpy(x), 0.1).numpy(),
        np.asarray(jcomp.topk_sparsify(jnp.asarray(x), 0.1)))


@pytest.mark.parametrize("codec", ["none", "int8", "topk"])
def test_one_rank_compressed_psum_gives_jaxs_bits(codec):
    cfg = CompressionConfig(codec=codec, topk_frac=0.25)
    jcfg = jcomp.CompressionConfig(codec=codec, topk_frac=0.25)
    rng = np.random.default_rng(3)
    g = rng.normal(size=(64,)).astype(np.float32)
    r = rng.normal(size=(64,)).astype(np.float32) * 0.1
    mesh = jax.make_mesh((1,), ("d",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    spec = jax.sharding.PartitionSpec()
    jout, jres = jax.shard_map(
        lambda g, r: jcomp.compressed_psum(g, r, "d", jcfg), mesh=mesh,
        in_specs=(spec,) * 2, out_specs=(spec,) * 2, check_vma=False)(
            jnp.asarray(g), jnp.asarray(r))
    (out,), (res,) = compressed_psum([torch.from_numpy(g)],
                                     [torch.from_numpy(r)], cfg)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_error_feedback_converges(codec):
    """With error feedback the accumulated compressed sum tracks the true
    gradient sum (the residual stays bounded)."""
    cfg = CompressionConfig(codec=codec, topk_frac=0.25)
    g_true = torch.from_numpy(np.random.default_rng(1).normal(size=(64,))
                              .astype(np.float32))
    residual = [torch.zeros_like(g_true)]
    total = torch.zeros_like(g_true)
    for _ in range(20):
        (sent,), residual = compressed_psum([g_true], residual, cfg)
        total = total + sent
    err = float((total / 20 - g_true).abs().max())
    assert err < 0.15 * float(g_true.abs().max()), err


def test_several_ranks_sum_as_defined():
    """Four ranks: every rank gets the same sum; int8 re-quantizes each
    rank against the largest scale and sums the int32 payloads; top-k
    sums each rank's sparse payload; the residuals are what each rank
    did not send."""
    rng = np.random.default_rng(4)
    gs = [rng.normal(size=(5, 12)).astype(np.float32) * (i + 1)
          for i in range(4)]
    tg = [torch.from_numpy(g) for g in gs]
    out, res = compressed_psum(tg, None, CompressionConfig(codec="none"))
    want = ((gs[0] + gs[1]) + gs[2]) + gs[3]
    for o, r in zip(out, res):
        np.testing.assert_array_equal(o.numpy(), want)
        assert float(r.abs().max()) == 0.0
    out, res = compressed_psum(tg, None, CompressionConfig(codec="int8"))
    smax = np.float32(max(np.abs(g).max() / np.float32(127.0)
                          + np.float32(1e-30) for g in gs))
    qs = [np.clip(np.round(g / smax), -127, 127).astype(np.int32) for g in gs]
    want = (sum(qs).astype(np.float32) * smax)
    for o, r, g, q in zip(out, res, gs, qs):
        np.testing.assert_array_equal(o.numpy(), want)
        np.testing.assert_allclose(r.numpy(), g - q * smax, rtol=0,
                                   atol=1e-6)
    out, res = compressed_psum(tg, None, CompressionConfig(
        codec="topk", topk_frac=0.25))
    sparse = [topk_sparsify(t, 0.25).numpy() for t in tg]
    want = ((sparse[0] + sparse[1]) + sparse[2]) + sparse[3]
    for o, r, g, s in zip(out, res, gs, sparse):
        np.testing.assert_array_equal(o.numpy(), want)
        np.testing.assert_array_equal(r.numpy(), g - s)


def test_tree_compressed_psum_maps_leaves_and_carries_residuals():
    rng = np.random.default_rng(5)
    trees = [{"a": torch.from_numpy(rng.normal(size=(4, 6))
                                    .astype(np.float32)),
              "b": [torch.from_numpy(rng.normal(size=(9,))
                                     .astype(np.float32))]}
             for _ in range(2)]
    cfg = CompressionConfig(codec="int8")
    out, res = tree_compressed_psum(trees, None, cfg)
    assert len(out) == len(res) == 2
    want_a, _ = compressed_psum([t["a"] for t in trees], None, cfg)
    assert torch.equal(out[1]["a"], want_a[1])
    assert isinstance(out[0]["b"], list) and out[0]["b"][0].shape == (9,)
    out2, _ = tree_compressed_psum(trees, res, cfg)
    want_b, _ = compressed_psum([t["b"][0] for t in trees],
                                [r["b"][0] for r in res], cfg)
    assert torch.equal(out2[0]["b"][0], want_b[0])
