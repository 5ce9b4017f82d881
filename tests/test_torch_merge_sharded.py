"""Vocab-sharded merges of the PyTorch port against the JAX package.

The port of ``tests/test_merge_sharded.py``: ``ShardedDeviceBackend`` on
grids of ``"cpu"`` (one shard, and 4 or 8 slices in-process, where the
JAX tests fork a process with 8 forced host devices) held against the
JAX package's ``HostBackend`` on the same numpy models, and against the
JAX ``ShardedDeviceBackend`` (Pallas in interpret mode, one device) at
1e-5.  The budget case runs on 8 distinct CPU device names
(``cpu:0`` .. ``cpu:7``), since a grid that repeats one device counts
every slice it holds.  Plus ``merge_stats``, ``padded_vocab``, the
``collective.merge`` fault site and the device-loss chain
``device_sharded -> device -> host``.  Each shard runs the merge kernels' plain versions here; the
card tests (``tests/test_torch_cuda.py``) launch the kernels.
"""
import threading

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.api.backend import HostBackend as JaxHost  # noqa: E402
from repro.api.backend import ShardedDeviceBackend as JaxSharded  # noqa: E402
from repro.configs.lda_default import LDAConfig as JaxCfg  # noqa: E402
from repro.core.lda import MaterializedModel as JaxModel  # noqa: E402
from repro.core.plans import Interval as JaxInterval  # noqa: E402
from repro.distributed.merge_collective import (  # noqa: E402
    padded_vocab as jax_padded_vocab)
from repro.distributed.sharding import (  # noqa: E402
    local_mesh_env as jax_local_mesh_env)
import repro_torch.api as tapi  # noqa: E402
from repro_torch.api import (  # noqa: E402
    DeviceBackend,
    ShardedDeviceBackend,
    make_backend,
)
from repro_torch.configs.lda_default import LDAConfig  # noqa: E402
from repro_torch.core.errors import DeviceLostError  # noqa: E402
from repro_torch.core.lda import MaterializedModel  # noqa: E402
from repro_torch.core.plans import Interval  # noqa: E402
from repro_torch.core.store import ModelStore  # noqa: E402
from repro_torch.data.corpus import make_corpus  # noqa: E402
from repro_torch.distributed.merge_collective import (  # noqa: E402
    merge_gs_collective,
    merge_stats,
    merge_vb_collective,
    padded_vocab,
)
from repro_torch.distributed.sharding import (  # noqa: E402
    MeshEnv,
    all_reduce,
    get_env,
    local_mesh_env,
    set_env,
    single_device_env,
)
from repro_torch.kernels.common import DeviceUnavailableError  # noqa: E402
from repro_torch.testing.faults import FaultRule, injected  # noqa: E402

FIELDS = dict(n_topics=6, vocab_size=150, alpha=0.5, eta=0.05)
CFG = LDAConfig(**FIELDS)
JCFG = JaxCfg(**FIELDS)
TOL = dict(rtol=1e-5, atol=1e-5)


def _models(n, kind, k=6, v=150, seed=0):
    """The same numpy statistics as models of both packages."""
    rng = np.random.default_rng(seed)
    key = "lam" if kind == "vb" else "delta_nkv"
    thetas = [{key: rng.gamma(1.0, 1.0, (k, v)).astype(np.float32)}
              for _ in range(n)]
    port = [MaterializedModel(i, Interval(float(i), i + 1.0), 10, 100, kind,
                              t) for i, t in enumerate(thetas)]
    jax = [JaxModel(i, JaxInterval(float(i), i + 1.0), 10, 100, kind, t)
           for i, t in enumerate(thetas)]
    return port, jax


def _sharded(shards, **kw):
    return ShardedDeviceBackend(env=MeshEnv([["cpu"] * shards]),
                                device="cpu", **kw)


def _logical_cpus(n):
    """A (1, n) grid of n distinct CPU device names (cpu:0 .. cpu:n-1):
    n devices to the cache's byte accounting, as the JAX tests' forced
    host devices are, though every tensor lies in host memory."""
    return MeshEnv([[torch.device("cpu", i) for i in range(n)]])


# ---------------------------------------------------------------------------
# one shard: the sharded semantics degrade to the unsharded ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["vb", "gs"])
def test_single_shard_matches_jax_host(kind):
    sharded = ShardedDeviceBackend(env=local_mesh_env("cpu"), device="cpu")
    ms, jms = _models(4, kind)
    np.testing.assert_allclose(sharded.merge(ms, kind, CFG),
                               JaxHost().merge(jms, kind, JCFG), **TOL)
    assert sharded.shards == 1 and sharded.name == "device_sharded"


@pytest.mark.parametrize("kind", ["vb", "gs"])
def test_single_shard_merge_many_matches_jax_host(kind):
    sharded = _sharded(1)
    ms, jms = _models(6, kind)
    got = sharded.merge_many([ms[:1], ms[1:4], ms[4:]], kind, CFG)
    want = JaxHost().merge_many([jms[:1], jms[1:4], jms[4:]], kind, JCFG)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    assert sharded.stats.pad_rows == 0
    assert sharded.stats.device_launches == 1


# ---------------------------------------------------------------------------
# several slices in-process: parity + over-budget model stacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["vb", "gs"])
@pytest.mark.parametrize("shards", [4, 8])
def test_sharded_merge_matches_jax_host(kind, shards):
    sharded = _sharded(shards)
    assert sharded.shards == shards
    ms, jms = _models(5, kind)
    np.testing.assert_allclose(sharded.merge(ms, kind, CFG),
                               JaxHost().merge(jms, kind, JCFG), **TOL)
    assert sharded.stats.device_launches == 1
    # every slice is a contiguous (K, Vp/shards) tensor; V = 150 pads
    slices = sharded.cache.get(ms[0], "lam" if kind == "vb" else
                               "delta_nkv")
    assert len(slices) == shards
    assert all(s.is_contiguous() and tuple(s.shape) ==
               (6, padded_vocab(150, shards) // shards) for s in slices)


@pytest.mark.parametrize("kind", ["vb", "gs"])
def test_sharded_ragged_batch_matches_jax_host_8_shards(kind):
    sharded = _sharded(8)
    ms, jms = _models(8, kind)
    cut = lambda xs: [xs[:1], xs[1:2], xs[2:7], xs[7:]]   # noqa: E731
    got = sharded.merge_many(cut(ms), kind, CFG)
    want = JaxHost().merge_many(cut(jms), kind, JCFG)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    assert sharded.stats.pad_rows == 0
    assert sharded.stats.device_launches == 1
    assert sharded.stats.merges == 4


def test_sharded_cache_holds_stack_over_single_device_budget():
    # Budget sized so ONE model already busts it unsharded (6 x 1000 f32
    # = 24000 B > 20000) but each device's 1/8 vocab slice set fits
    # (6 x 3072 B = 18432): the sharded cache keeps the whole stack
    # resident while the single-device cache can't hold even one model.
    # The 8 shards are 8 distinct device names.
    kind, n, max_bytes = "vb", 6, 20_000
    ms, jms = _models(n, kind, v=1000)
    want = JaxHost().merge(jms, kind, JCFG)

    sharded = ShardedDeviceBackend(env=_logical_cpus(8), max_bytes=max_bytes)
    np.testing.assert_allclose(sharded.merge(ms, kind, CFG), want, **TOL)
    assert sum(m.theta["lam"].nbytes for m in ms) > max_bytes
    assert len(sharded.cache) == n
    assert sharded.cache.evictions == 0
    assert sharded.cache.resident_bytes == n * 3072 <= max_bytes

    single = DeviceBackend(max_bytes=max_bytes, device="cpu")
    np.testing.assert_allclose(single.merge(ms, kind, CFG), want, **TOL)
    assert single.cache.evictions > 0 or len(single.cache) < n


@pytest.mark.parametrize("kind", ["vb", "gs"])
def test_matches_the_jax_sharded_backend(kind):
    """The JAX backend's shard_map merge (Pallas in interpret mode, one
    device) against the port's 8 slices, single and ragged."""
    jax_b = JaxSharded(interpret=True, env=jax_local_mesh_env(max_devices=1))
    port_b = _sharded(8)
    ms, jms = _models(6, kind)
    np.testing.assert_allclose(port_b.merge(ms[:3], kind, CFG),
                               jax_b.merge(jms[:3], kind, JCFG), **TOL)
    got = port_b.merge_many([ms[:2], ms[2:3], ms[3:]], kind, CFG)
    want = jax_b.merge_many([jms[:2], jms[2:3], jms[3:]], kind, JCFG)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_shared_backend_under_concurrent_merges():
    """Threads sharing one sharded backend (the service's workers) get
    the answers one thread gets, and no count is lost."""
    import sys
    backend = _sharded(4, capacity=3)     # evictions race with merges
    ms, jms = _models(6, "vb")
    want = [JaxHost().merge(jms[i:i + 3], "vb", JCFG) for i in range(4)]
    errors, n_threads, rounds = [], 8, 10
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(t):
            try:
                for r in range(rounds):
                    i = (t + r) % 4
                    np.testing.assert_allclose(
                        backend.merge(ms[i:i + 3], "vb", CFG), want[i],
                        **TOL)
            except BaseException as exc:    # reported by the main thread
                errors.append(exc)
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors[0]
    assert backend.stats.merges == n_threads * rounds
    assert backend.stats.device_launches == n_threads * rounds
    # each model: 4 slices of (6, 128) f32, all on the one CPU device
    assert backend.cache.resident_bytes == \
        len(backend.cache) * 4 * 6 * 128 * 4


@pytest.mark.parametrize("distinct, resident, evictions",
                         [(1, 0, 0), (2, 0, 0), (4, 1, 2), (8, 3, 0)])
def test_a_device_named_twice_counts_every_slice_it_holds(distinct, resident,
                                                          evictions):
    """A (1, 8) grid over ``distinct`` device names counts each entry at
    the slices its most-loaded device holds: 8 / distinct of them.  A
    cap of 3 slices holds all 3 models only on 8 distinct devices, and
    no model at all where one device holds 4 or 8 slices of it."""
    env = MeshEnv([[torch.device("cpu", s % distinct) for s in range(8)]])
    ms, jms = _models(3, "vb", v=1000)
    want = JaxHost().merge(jms, "vb", JCFG)
    slice_bytes = 6 * 128 * 4
    backend = ShardedDeviceBackend(env=env)
    np.testing.assert_allclose(backend.merge(ms, "vb", CFG), want, **TOL)
    assert backend.cache.resident_bytes == 3 * (8 // distinct) * slice_bytes

    capped = ShardedDeviceBackend(env=env, max_bytes=3 * slice_bytes)
    np.testing.assert_allclose(capped.merge(ms, "vb", CFG), want, **TOL)
    assert (len(capped.cache), capped.cache.evictions) == (resident,
                                                           evictions)
    assert capped.cache.resident_bytes == \
        resident * (8 // distinct) * slice_bytes <= 3 * slice_bytes


# ---------------------------------------------------------------------------
# collectives and the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [(1, 1), (2, 1), (2, 4), (8, 2)])
@pytest.mark.parametrize("kind", ["vb", "gs"])
def test_merge_stats_matches_eta_plus_deltas(grid, kind):
    rng = np.random.default_rng(3)
    eta = 0.05
    stats = rng.gamma(1.0, 1.0, (8, 4, 64)).astype(np.float32)
    env = MeshEnv([["cpu"] * grid[1]] * grid[0])
    got = merge_stats(torch.from_numpy(stats), env, kind=kind, eta=eta)
    want = (eta + (stats - eta).sum(0)) if kind == "vb" else stats.sum(0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_vb_and_gs_collectives_reduce_over_the_data_axis():
    rng = np.random.default_rng(4)
    lams = [rng.gamma(1.0, 1.0, (4, 32)).astype(np.float32)
            for _ in range(3)]
    env = MeshEnv([["cpu"]] * 3)
    got = merge_vb_collective([torch.from_numpy(x) for x in lams], 0.05,
                              env, weights=[0.5, 1.0, 2.0])
    want = 0.05 + sum(w * (x - 0.05) for w, x in zip([0.5, 1.0, 2.0], lams))
    assert len(got) == 3
    for g in got:
        np.testing.assert_allclose(g.numpy(), want, **TOL)
    got = merge_gs_collective([torch.from_numpy(x) for x in lams], env,
                              decay=0.9, staleness=[0, 1, 2])
    want = sum(0.9 ** s * x for s, x in zip([0, 1, 2], lams))
    np.testing.assert_allclose(got[2].numpy(), want, **TOL)
    with pytest.raises(ValueError, match="one tensor per data rank"):
        merge_gs_collective([torch.from_numpy(lams[0])], env)


def test_all_reduce_adds_in_grid_order():
    xs = [torch.tensor([1e8], dtype=torch.float32),
          torch.tensor([1.0]), torch.tensor([-1e8])]
    out = all_reduce(xs)
    # (1e8 + 1) - 1e8 in float32 is 0: the order is the grid's, always
    assert [float(o) for o in out] == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("v", [1, 127, 128, 129, 150, 1000, 4097, 8192])
def test_padded_vocab_equals_jax(v, shards):
    assert padded_vocab(v, shards) == jax_padded_vocab(v, shards)
    assert padded_vocab(v, shards) % (shards * 128) == 0


def test_mesh_env_shape_and_validation():
    env = MeshEnv([["cpu"] * 4] * 2)
    assert env.axis_names == ("data", "model")
    assert env.dp_axes == ("data",) and env.tp_axis == "model"
    assert (env.dp_size, env.tp_size, env.size(("data", "model"))) == \
        (2, 4, 8)
    assert env.first == torch.device("cpu")
    with pytest.raises(ValueError, match="rectangular"):
        MeshEnv([["cpu"] * 2, ["cpu"]])
    assert local_mesh_env("cpu").tp_size == 1
    one = single_device_env("cpu")
    assert get_env() is None
    with set_env(one):
        assert get_env() is one
        with set_env(env):
            assert get_env() is env
        assert get_env() is one
    assert get_env() is None


def test_device_sharded_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(DeviceUnavailableError):
        make_backend("device_sharded")
    with pytest.raises(DeviceUnavailableError):
        local_mesh_env()
    assert make_backend("device_sharded", device="cpu").shards == 1
    with pytest.raises(ValueError, match="first device"):
        ShardedDeviceBackend(env=MeshEnv([["cpu"]]), device="meta")


# ---------------------------------------------------------------------------
# fault sites and the device-loss chain
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    return make_corpus(300, 150, 6, mean_doc_len=30, seed=3)[0]


def _store():
    """Two mergeable windows of [0, 200)."""
    store = ModelStore()
    rng = np.random.default_rng(9)
    for lo in (0.0, 100.0):
        store.add(Interval(lo, lo + 100.0), 50, 500, "vb",
                  {"lam": rng.gamma(1.0, 1.0, (6, 150)).astype(np.float32)})
    return store


def test_collective_merge_fault_site(corpus):
    backend = _sharded(2)
    ms, _ = _models(3, "vb")
    with injected(FaultRule("collective.merge", kind="permanent",
                            max_failures=1)):
        with pytest.raises(tapi.PermanentExecutionError):
            backend.merge(ms, "vb", CFG)
        backend.merge(ms, "vb", CFG)                 # fired once only
    with injected(FaultRule("collective.merge", kind="device_lost",
                            max_failures=1)):
        with pytest.raises(DeviceLostError):
            backend.merge_many([ms[:1], ms[1:]], "vb", CFG)
    # a device loss inside the collective fails over like any other
    s = tapi.MLegoSession(corpus, CFG, store=_store(), backend=_sharded(2),
                          device="cpu")
    with injected(FaultRule("collective.merge", kind="device_lost",
                            max_failures=1)):
        rep = s.submit(tapi.QuerySpec(sigma=Interval(0.0, 200.0)))
    assert (rep.backend, rep.fallback_from) == ("device", "device_sharded")


def test_fallback_chain_sharded_device_host(corpus):
    store = _store()
    s = tapi.MLegoSession(corpus, CFG, store=store,
                          backend="device_sharded", device="cpu")
    spec = tapi.QuerySpec(sigma=Interval(0.0, 200.0))
    clean = s.submit(spec)
    assert (clean.backend, clean.fallback_from) == ("device_sharded", None)
    with injected(FaultRule("backend.merge.device_sharded",
                            kind="device_lost", max_failures=1)):
        first = s.submit(spec)
    assert (first.backend, first.fallback_from) == ("device",
                                                    "device_sharded")
    assert s.backend.quarantined
    with injected(FaultRule("backend.merge", kind="device_lost",
                            max_failures=2)):
        second = s.submit(spec)
    assert (second.backend, second.fallback_from) == ("host",
                                                      "device_sharded")
    for rep in (first, second):
        np.testing.assert_allclose(rep.beta, clean.beta, **TOL)
    # a permanent error fails the query and replays on nothing
    s2 = tapi.MLegoSession(corpus, CFG, store=store,
                           backend="device_sharded", device="cpu")
    with injected(FaultRule("backend.merge.device_sharded",
                            kind="permanent", max_failures=1)):
        with pytest.raises(tapi.PermanentExecutionError):
            s2.submit(spec)
    assert not s2.backend.quarantined
