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
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch

from repro_torch.distributed.checkpoint import CheckpointManager
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


def make_train_step(model: Model, opt_cfg: OptimizerConfig, *,
                    remat: bool = True):
    """(params, opt_state, step, batch) -> (params', opt_state', step + 1,
    metrics {"loss", "grad_norm", "nll", "aux"}, 0-d tensors on the
    device).  The gradients are taken with respect to the compute-dtype
    copies of the float32 masters (``Model.cast_params``: the stacked ≥2-D
    rule of JAX's ``cast_params``), cast to float32 and applied to the
    masters by the optimizer, built with ``model.jax_stacks`` for its
    rules that read JAX's stacked layout."""

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
                 device=None):
        """``device``: where the state lives and the steps run (the
        current card by default; ``"cpu"`` for the CPU; a card asked for
        without one raises ``DeviceUnavailableError``)."""
        self.model = model
        self.opt_cfg = opt_cfg
        self.device = resolve_device(device)
        self.save_every = save_every
        self.ckpt = (CheckpointManager(ckpt_dir, keep=keep)
                     if ckpt_dir else None)
        self._opt_init = build_optimizer(opt_cfg)[0]
        self._step_fn = make_train_step(model, opt_cfg, remat=remat)
        self._seed = seed

    def init_state(self) -> TrainState:
        """Float32 masters drawn by ``Model.init`` from a generator on the
        device seeded with ``seed``; ``rng`` is that generator's state
        after seeding (JAX keeps its ``PRNGKey(seed)``)."""
        gen = torch.Generator(device=self.device).manual_seed(self._seed)
        rng = gen.get_state()
        params = self.model.init(gen)
        return TrainState(params=params, opt_state=self._opt_init(params),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=self.device),
                          rng=rng, data_cursor=0)

    def restore_or_init(self) -> TrainState:
        if self.ckpt is not None:
            loaded = self.ckpt.restore_latest()
            if loaded is not None:
                tree, meta = loaded

                def dev(t):
                    return t.to(self.device)

                return TrainState(
                    params=tree_map(dev, tree["params"]),
                    opt_state=tree_map(dev, tree["opt_state"]),
                    step=torch.tensor(meta["step"], dtype=torch.int32,
                                      device=self.device),
                    rng=tree["rng"], data_cursor=int(meta["data_cursor"]))
        return self.init_state()

    def save(self, state: TrainState) -> None:
        if self.ckpt is None:
            return
        step = int(state.step)
        self.ckpt.save(
            {"params": state.params, "opt_state": state.opt_state,
             "rng": state.rng},
            meta={"step": step, "data_cursor": int(state.data_cursor)},
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
