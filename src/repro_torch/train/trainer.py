"""Training loop: the train-step factory and a fault-tolerant Trainer.

The port of ``src/repro/train/trainer.py``.  ``make_train_step`` composes
``Model.loss``, its gradients and the optimizer update into one function
(JAX jits the same composition).  ``Trainer`` wraps it with the
checkpoint manager (atomic save and restore of the parameters, the
optimizer state, the generator state and the data cursor), so a killed
and restarted run continues bit for bit.

No host sync inside the loop: ``TrainState.step`` is a 0-d int32 tensor
on the device, the learning rate is computed from it there, and ``fit``
reads the device only when it logs (the loss and the gradient norm) and
when it saves.  The gradients are deterministic on the card as on the
CPU: every scatter on the backward path adds at most one value to a
position, except the embedding gather's (an ``index_put_`` with
``accumulate=True``), which PyTorch computes on CUDA by sorting the
indices (its ``use_deterministic_algorithms`` documentation lists only
the CPU form as nondeterministic).

On a grid (``env``; JAX's ``trainer.py:64-75``): the float32 masters and
the optimizer state rest as ``Sharded`` pieces by ``infer_param_specs``
(the train profile's 2-D FSDP over ("data", "model")), each piece a
tensor of its own.  The step casts the pieces and takes the gradients
with respect to them, so they come back in the masters' layout: where
several devices use a leaf, its pieces' gradients are added in device
order (``gather_for_compute``), and a replicated leaf's copies on
distinct devices are added in cell order (``sharding.sum_replicas``), so
the data-parallel sum has a fixed order.  The update then runs on the
pieces (``build_optimizer(..., env=)``): each card updates only the
pieces it holds, as XLA does with JAX's gradients pinned to the masters'
sharding, and no card builds a whole master, moment or gradient.  A
checkpoint holds whole tensors, the same files as on one device, joined
leaf by leaf on the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.sharding import MeshEnv
from repro_torch.kernels.common import resolve_device
from repro_torch.models.model import Model, Params
from repro_torch.train.optim import (OptimizerConfig, build_optimizer,
                                     leaves, tree_map, unflatten)


@dataclasses.dataclass
class TrainState:
    params: Params               # float32 masters
    opt_state: Any
    step: torch.Tensor           # () int32, on the parameters' device
    rng: torch.Tensor            # the torch generator's state (uint8, CPU)
    data_cursor: int = 0         # host-side; checkpointed


def shard_tree(tree: Any, env: MeshEnv, like: Any = None) -> Any:
    """Every tensor of ``tree`` cut into ``Sharded`` pieces by
    ``infer_param_specs`` (the optimizer state takes its parameters'
    rules: ``"m/layers/3/attn/wq"`` reads as its parameter), each piece a
    tensor of its own.  Each leaf is replaced in its dict or list by its
    pieces as it is cut, so no whole leaf outlives its cut once the caller
    holds no other reference to it.  ``like``: a tree of the same leaves'
    shapes whose containers ``tree`` takes (a checkpoint gives lists where
    the Adafactor state has tuples)."""
    if like is not None:
        tree = unflatten(like, leaves(tree))
    specs = sh.infer_param_specs(tree, env)

    def go(node, spec):
        if isinstance(node, (dict, list)):
            for k in (sorted(node) if isinstance(node, dict)
                      else range(len(node))):
                node[k] = go(node[k], spec[k])
            return node
        if isinstance(node, tuple):
            return tuple(go(v, sp) for v, sp in zip(node, spec))
        return sh.own_pieces(sh.shard(node, spec, env))

    return go(tree, specs)


def join_tree(tree: Any, env: MeshEnv, device=None) -> Any:
    """The inverse of :func:`shard_tree`: every ``Sharded`` leaf whole on
    ``device`` (the first cell's by default), joined one leaf at a
    time."""
    if isinstance(tree, sh.Sharded):
        return sh.unshard(tree, None, env, device)
    if isinstance(tree, dict):
        return {k: join_tree(v, env, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(join_tree(v, env, device) for v in tree)
    return tree


def _pieces(tree: Any) -> list:
    """The distinct tensors of a tree of ``Sharded`` leaves, in leaf
    order."""
    if isinstance(tree, sh.Sharded):
        return list({id(t): t for t in tree}.values())
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _pieces(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _pieces(v)]
    return [tree]


def _map_pieces(fn, tree: Any) -> Any:
    """``fn`` on every distinct piece of a tree of ``Sharded`` leaves."""
    if isinstance(tree, sh.Sharded):
        made = {}
        for t in tree:
            if id(t) not in made:
                made[id(t)] = fn(t)
        return sh.Sharded([made[id(t)] for t in tree], tree.spec)
    if isinstance(tree, dict):
        return {k: _map_pieces(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_pieces(fn, v) for v in tree)
    return fn(tree)


def make_train_step(model: Model, opt_cfg: OptimizerConfig, *,
                    remat: bool = True, env: Optional[MeshEnv] = None):
    """(params, opt_state, step, batch) -> (params', opt_state', step + 1,
    metrics {"loss", "grad_norm", "nll", "aux"}, 0-d tensors on the
    device).  The gradients are taken with respect to the compute-dtype
    copies of the float32 masters (``Model.cast_params``: the stacked ≥2-D
    rule of JAX's ``cast_params``), cast to float32 and applied to the
    masters by the optimizer, built with ``model.jax_stacks`` for its
    rules that read JAX's stacked layout.  With ``env``: params and
    opt_state are trees of ``Sharded`` pieces (:func:`shard_tree`), the
    update runs on the pieces, and the step returns new pieces on the
    same cells under the same specs."""

    def grid_step(params, opt_state, step, batch):
        with torch.no_grad():
            p_compute = _map_pieces(lambda x: x.detach().requires_grad_(),
                                    model.cast_params(params))
        loss, metrics = model.loss(p_compute, batch, remat=remat, env=env)
        flat = _pieces(p_compute)
        got = torch.autograd.grad(loss, flat, allow_unused=True)
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in metrics.items()}}
        by_id = {id(t): torch.zeros_like(t) if g is None else g
                 for t, g in zip(flat, got)}
        grads = _map_pieces(lambda t: by_id[id(t)], p_compute)
        del loss, metrics, p_compute, flat, got, by_id
        grads = _map_pieces(lambda g: g.float(), tree_map(
            lambda g: sh.sum_replicas(g, env), grads))
        update = build_optimizer(opt_cfg, model.jax_stacks(params),
                                 env=env)[1]
        new_params, new_opt, out["grad_norm"] = update(grads, opt_state,
                                                       params, step)
        return new_params, new_opt, step + 1, out

    if env is not None:
        return grid_step

    def train_step(params: Params, opt_state: Any, step: torch.Tensor,
                   batch: Dict[str, torch.Tensor]):
        update = build_optimizer(opt_cfg, model.jax_stacks(params))[1]
        with torch.no_grad():
            p_compute = tree_map(lambda x: x.detach().requires_grad_(),
                                 model.cast_params(params))
        loss, metrics = model.loss(p_compute, batch, remat=remat)
        flat = leaves(p_compute)
        grads = torch.autograd.grad(loss, flat)
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in metrics.items()}}
        # the graph's root holds the compute copies: free both first
        del loss, metrics, p_compute, flat
        grads = unflatten(params, [g.float() for g in grads])
        new_params, new_opt, out["grad_norm"] = update(grads, opt_state,
                                                       params, step)
        return new_params, new_opt, step + 1, out

    return train_step


class Trainer:
    def __init__(self, model: Model, opt_cfg: OptimizerConfig, *,
                 ckpt_dir: Optional[str] = None, keep: int = 3,
                 save_every: int = 50, remat: bool = True, seed: int = 0,
                 device=None, env: Optional[MeshEnv] = None):
        """``device``: where the state lives and the steps run (the
        current card by default; ``"cpu"`` for the CPU; a card asked for
        without one raises ``DeviceUnavailableError``).  ``env``: the grid
        the state is sharded over and the steps run on (its first cell is
        ``device``)."""
        self.model = model
        self.opt_cfg = opt_cfg
        self.env = env
        self.device = env.first if env is not None else resolve_device(
            device)
        self.save_every = save_every
        self.ckpt = (CheckpointManager(ckpt_dir, keep=keep)
                     if ckpt_dir else None)
        self._opt_init = build_optimizer(opt_cfg)[0]
        self._step_fn = make_train_step(model, opt_cfg, remat=remat, env=env)
        self._seed = seed

    def init_state(self) -> TrainState:
        """Float32 masters drawn by ``Model.init`` from a generator on the
        device seeded with ``seed``; ``rng`` is that generator's state
        after seeding (JAX keeps its ``PRNGKey(seed)``).  On a grid the
        masters are drawn whole on the first cell, as JAX draws them, and
        cut leaf by leaf; the optimizer state is made on the pieces."""
        gen = torch.Generator(device=self.device).manual_seed(self._seed)
        rng = gen.get_state()
        params = self.model.init(gen)
        if self.env is None:
            opt_state = self._opt_init(params)
        else:
            params = shard_tree(params, self.env)
            opt_state = self._state_on_pieces(params)
        return TrainState(params=params, opt_state=opt_state,
                          step=torch.zeros((), dtype=torch.int32,
                                           device=self.device),
                          rng=rng, data_cursor=0)

    def _state_like(self, params: Any) -> Any:
        """The optimizer state of ``params``' whole shapes, on the ``meta``
        device (shapes only)."""
        def meta(t):
            if isinstance(t, sh.Sharded):
                return torch.empty(sh.whole_shape(t, self.env),
                                   dtype=t[0].dtype, device="meta")
            return torch.empty(t.shape, dtype=t.dtype, device="meta")
        return self._opt_init(tree_map(meta, params))

    def _state_on_pieces(self, params: Any) -> Any:
        """The optimizer's initial state as ``Sharded`` zeros by
        ``infer_param_specs``, made on each cell (no whole leaf)."""
        like = self._state_like(params)
        shs = leaves(sh.param_shardings(like, self.env))
        return unflatten(like, [sh.zeros(t.shape, s.spec, self.env, t.dtype)
                                for t, s in zip(leaves(like), shs)])

    def restore_or_init(self) -> TrainState:
        if self.ckpt is not None:
            loaded = self.ckpt.restore_latest()
            if loaded is not None:
                tree, meta = loaded
                if self.env is None:
                    params = tree_map(lambda t: t.to(self.device),
                                      tree["params"])
                    opt_state = tree_map(lambda t: t.to(self.device),
                                         tree["opt_state"])
                else:   # each host leaf cut straight to its cells
                    like = self._state_like(tree["params"])
                    params = shard_tree(tree.pop("params"), self.env)
                    opt_state = shard_tree(tree.pop("opt_state"),
                                           self.env, like=like)
                return TrainState(
                    params=params, opt_state=opt_state,
                    step=torch.tensor(meta["step"], dtype=torch.int32,
                                      device=self.device),
                    rng=tree["rng"], data_cursor=int(meta["data_cursor"]))
        return self.init_state()

    def save(self, state: TrainState) -> None:
        if self.ckpt is None:
            return
        step = int(state.step)
        tree = {"params": state.params, "opt_state": state.opt_state}
        if self.env is not None:    # each leaf joined on the host in turn
            tree = join_tree(tree, self.env, device="cpu")
        self.ckpt.save({**tree, "rng": state.rng},
                       meta={"step": step,
                             "data_cursor": int(state.data_cursor)},
                       step=step)

    def fit(self, state: TrainState, batches: Iterator[Dict[str, Any]],
            n_steps: int, log_every: int = 10,
            log_fn: Callable[[str], None] = print) -> TrainState:
        """``n_steps`` steps on ``next(batches)``; saves every
        ``save_every`` steps and at the end when a checkpoint directory
        was given.  Reads the device when it logs and when it saves (and
        once at the start, for the step count, when it may save)."""
        t0 = time.perf_counter()
        host_step = int(state.step) if self.ckpt is not None else 0
        for i in range(n_steps):
            batch = next(batches)
            params, opt_state, step, metrics = self._step_fn(
                state.params, state.opt_state, state.step, batch)
            state = TrainState(params=params, opt_state=opt_state,
                               step=step, rng=state.rng,
                               data_cursor=state.data_cursor + 1)
            host_step += 1
            if log_every and (i + 1) % log_every == 0:
                dt = time.perf_counter() - t0
                log_fn(f"step {int(state.step):5d} "
                       f"loss {float(metrics['loss']):.4f} "
                       f"gnorm {float(metrics['grad_norm']):.3f} "
                       f"({dt / (i + 1):.3f}s/step)")
            if self.ckpt is not None and host_step % self.save_every == 0:
                self.save(state)
        if self.ckpt is not None:
            self.save(state)
        return state
