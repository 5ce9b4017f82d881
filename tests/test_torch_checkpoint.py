"""The port's checkpointing and trainer restart, and checkpoints read
across the two packages.

Mirrors ``tests/test_checkpoint.py`` (round trip, keep-N pruning,
corruption detected, a trainer restarted from its checkpoint continuing
bit for bit, on one device and on a (2, 2) grid), then crosses the
packages: a checkpoint JAX's ``Trainer``
wrote (reduced smollm-360m) resumes in the port through
``params_from_jax`` and ``opt_state_from_jax``, and the next step's loss
and parameters match JAX's next step at 1e-4 (the JAX tests' float32
tolerance; see ``tests/test_torch_train.py`` for the parameters'); JAX's
``CheckpointManager`` reads the port's checkpoint leaf for leaf.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.data.lm import batch_stream as jax_batch_stream  # noqa: E402
from repro.distributed.checkpoint import (  # noqa: E402
    CheckpointManager as JaxCheckpointManager)
from repro.distributed.sharding import single_device_env  # noqa: E402
from repro.models.model import build_model as jax_build_model  # noqa: E402
from repro.train.optim import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.train.trainer import Trainer as JaxTrainer  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.lm import batch_stream  # noqa: E402
from repro_torch.distributed.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.distributed.sharding import MeshEnv  # noqa: E402
from repro_torch.models.convert import (opt_state_from_jax,  # noqa: E402
                                        params_from_jax)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import OptimizerConfig, Trainer, make_train_step  # noqa: E402
from repro_torch.train.optim import leaves  # noqa: E402
from repro_torch.train.trainer import join_tree  # noqa: E402

TOL = 1e-4


def test_roundtrip_tree(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.ones((3, 4), dtype=torch.int32),
                  "d": [np.zeros(2), torch.full((2, 2), 7.0)],
                  "e": (torch.tensor(3, dtype=torch.int32),
                        torch.zeros(5, dtype=torch.uint8))}}
    cm.save(tree, meta={"step": 5, "data_cursor": 9}, step=5)
    loaded, meta = cm.restore(5)
    assert meta["step"] == 5 and meta["data_cursor"] == 9
    assert isinstance(loaded["b"]["d"], list)
    assert isinstance(loaded["b"]["e"], list)     # JAX's rule: idx -> list
    for a, b in zip(leaves(tree), leaves(loaded)):
        assert isinstance(b, torch.Tensor)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype


def test_keep_n_pruning(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        cm.save({"x": torch.full((3,), float(s))}, step=s)
    assert [s for s, _ in cm._step_dirs()] == [3, 4]
    assert cm.latest_step() == 4
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp_")]


def test_corruption_detected(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    cm.save({"x": torch.arange(100.0)}, step=1)
    d = os.path.join(str(tmp_path), "step_000000001")
    blob = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    with open(os.path.join(d, blob), "r+b") as f:
        f.seek(-4, 2)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(IOError):
        cm.restore(1)


def test_a_bfloat16_leaf_raises_and_publishes_nothing(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    with pytest.raises(TypeError, match="bfloat16"):
        cm.save({"x": torch.zeros(3, dtype=torch.bfloat16)}, step=1)
    assert cm.latest_step() is None and os.listdir(tmp_path) == []


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_trainer_restart_bit_identical(tmp_path, name):
    """Train 6 steps; separately train 4, save, restore in a new Trainer
    and train 2 more: the same bits (deterministic data cursor, the same
    ops in the same order).  Adafactor's (vr, vc) tuples come back as
    lists, as in JAX."""
    cfg = get_arch("smollm-360m").reduced()
    model = build_model(cfg)
    opt = OptimizerConfig(name=name, lr=1e-3, warmup_steps=2,
                          factored_min_dim=16)
    t0 = Trainer(model, opt, ckpt_dir=None, remat=False, device="cpu")
    s = t0.fit(t0.init_state(), batch_stream(cfg, 2, 16, seed=0), 6,
               log_every=0)
    t1 = Trainer(model, opt, ckpt_dir=str(tmp_path), save_every=4,
                 remat=False, device="cpu")
    s1 = t1.fit(t1.init_state(), batch_stream(cfg, 2, 16, seed=0), 4,
                log_every=0)
    t2 = Trainer(model, opt, ckpt_dir=str(tmp_path), save_every=100,
                 remat=False, device="cpu")
    s2 = t2.restore_or_init()
    assert int(s2.step) == 4 and s2.step.dtype == torch.int32
    assert s2.data_cursor == 4
    assert torch.equal(s2.rng, s1.rng)
    s2 = t2.fit(s2, batch_stream(cfg, 2, 16, seed=0,
                                 start_cursor=s2.data_cursor), 2,
                log_every=0)
    for a, b in zip(leaves(s.params) + leaves(s.opt_state),
                    leaves(s2.params) + leaves(s2.opt_state)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_grid_trainer_restarts_bit_identical(tmp_path, name):
    """The same restart on a (2, 2) grid: the checkpoint holds whole
    leaves (joined on the host, the same files as on one device), the
    restore cuts them back into pieces of their own (Adafactor's lists
    back into tuples), and 4 + 2 steps give the 6 steps' bits."""
    cfg = get_arch("smollm-360m").reduced()
    model = build_model(cfg)
    env = MeshEnv([["cpu"] * 2] * 2)
    opt = OptimizerConfig(name=name, lr=1e-3, warmup_steps=2,
                          factored_min_dim=16)
    t0 = Trainer(model, opt, remat=False, env=env)
    s = t0.fit(t0.init_state(), batch_stream(cfg, 2, 16, seed=0), 6,
               log_every=0)
    t1 = Trainer(model, opt, ckpt_dir=str(tmp_path), save_every=4,
                 remat=False, env=env)
    s1 = t1.fit(t1.init_state(), batch_stream(cfg, 2, 16, seed=0), 4,
                log_every=0)
    saved = CheckpointManager(str(tmp_path)).restore(4)[0]
    assert [tuple(t.shape) for t in leaves(saved["params"])] == [
        tuple(t.shape) for t in leaves(model.init(
            torch.Generator().manual_seed(0)))]
    t2 = Trainer(model, opt, ckpt_dir=str(tmp_path), save_every=100,
                 remat=False, env=env)
    s2 = t2.restore_or_init()
    assert int(s2.step) == 4 and s2.data_cursor == 4
    wq = s2.params["layers"][0]["attn"]["wq"]
    assert wq.spec == s1.params["layers"][0]["attn"]["wq"].spec
    assert wq[0].untyped_storage().nbytes() == wq[0].numel() * 4
    s2 = t2.fit(s2, batch_stream(cfg, 2, 16, seed=0,
                                 start_cursor=s2.data_cursor), 2,
                log_every=0)
    want = leaves(join_tree(s.params, env)) + leaves(
        join_tree(s.opt_state, env))
    got = leaves(join_tree(s2.params, env)) + leaves(
        join_tree(s2.opt_state, env))
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_fit_logs_and_saves_on_schedule(tmp_path):
    cfg = get_arch("qwen3-1.7b").reduced()
    lines = []
    t = Trainer(build_model(cfg), OptimizerConfig(lr=1e-3, warmup_steps=2),
                ckpt_dir=str(tmp_path), keep=5, save_every=2, remat=True,
                device="cpu")
    t.fit(t.init_state(), batch_stream(cfg, 2, 16), 5, log_every=2,
          log_fn=lines.append)
    assert [ln.split()[1] for ln in lines] == ["2", "4"]
    assert [s for s, _ in t.ckpt._step_dirs()] == [2, 4, 5]


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX's Trainer trains reduced smollm-360m 2 steps and saves; the
    port restores that checkpoint and takes step 3 on JAX's next batch:
    its loss and new parameters match JAX's step 3."""
    cfg = JAX_ARCHS["smollm-360m"].reduced()
    env = single_device_env()
    jopt = JaxOptimizerConfig(lr=1e-3, warmup_steps=2)
    jt = JaxTrainer(jax_build_model(cfg), jopt, env, ckpt_dir=str(tmp_path),
                    save_every=100, remat=False)
    js = jt.fit(jt.init_state(), jax_batch_stream(cfg, 2, 16, seed=0), 2,
                log_every=0)
    batch = next(jax_batch_stream(cfg, 2, 16, seed=0, start_cursor=2))
    jparams, _, _, jmet = jt._step_fn(js.params, js.opt_state, js.step,
                                      batch)

    tree, meta = CheckpointManager(str(tmp_path)).restore_latest()
    assert meta["step"] == 2 and meta["data_cursor"] == 2
    tcfg = get_arch("smollm-360m").reduced()
    params = params_from_jax(tcfg, tree["params"])
    opt_state = opt_state_from_jax(tcfg, "adamw", tree["opt_state"])
    step = torch.tensor(meta["step"], dtype=torch.int32)
    new_params, _, step, met = make_train_step(
        build_model(tcfg), OptimizerConfig(lr=1e-3, warmup_steps=2),
        remat=False)(params, opt_state, step,
                     {k: torch.from_numpy(np.array(v))
                      for k, v in batch.items()})
    assert int(step) == 3
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=TOL, atol=TOL)
    want = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams))
    for a, b in zip(leaves(new_params), leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL)


def test_jax_reads_the_ports_checkpoint(tmp_path):
    cfg = get_arch("smollm-360m").reduced()
    t = Trainer(build_model(cfg), OptimizerConfig(lr=1e-3, warmup_steps=2),
                ckpt_dir=str(tmp_path), remat=False, device="cpu")
    state = t.fit(t.init_state(), batch_stream(cfg, 2, 16), 2, log_every=0)
    tree, meta = JaxCheckpointManager(str(tmp_path)).restore_latest()
    assert meta == {"step": 2, "data_cursor": 2}
    want = {"params": state.params, "opt_state": state.opt_state,
            "rng": state.rng}
    got = jax.tree.leaves(tree)
    assert len(got) == len(leaves(want))
    for a, b in zip(got, leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert isinstance(tree["params"]["layers"], list)
    assert jnp.asarray(tree["params"]["embed"]).shape == \
        tuple(state.params["embed"].shape)
