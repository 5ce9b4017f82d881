"""Per-cell step specs: (arch × shape × grid) -> the step and its inputs.

The port of ``src/repro/launch/specs.py``: what a dry run
(``launch/dryrun.py``) runs for each cell.  JAX builds
``ShapeDtypeStruct`` trees with ``jax.eval_shape`` and lowers the step;
the port builds fake tensors (call these functions inside a
``torch._subclasses.fake_tensor.FakeTensorMode``: shapes and dtypes, no
storage) and runs its own entry points on them:

  * train — ``train.trainer.make_train_step(..., env=)``: the float32
    masters and the optimizer state as ``Sharded`` pieces by the port's
    ``infer_param_specs`` (the state takes its parameter's rule, JAX's
    ``_opt_specs``), the step counter on the first cell, the batch by
    ``batch_specs``; AdamW, or Adafactor above ``ADAFACTOR_THRESHOLD``
    parameters (:func:`pick_optimizer`); remat per pattern group;
  * prefill — ``Model.prefill(..., env=)`` over a prompt of the shape's
    length;
  * decode — ``Model.decode_step(..., env=)``: one token against caches
    of the shape's length (``Model.init_cache(..., env=)``, cut by
    ``cache_specs``), at a position held on the card.

Two differences from JAX's specs, both of the port's entry points: the
serving steps take the weights already in the compute dtype
(``Model.init(gen, cast=True)``, what the port's serving path holds on
the card), where JAX's take the float32 masters and cast them inside the
step; and each step joins its batch (tokens, the VLM's patch embeddings,
the encoder's frames, a decode step's token) whole on the host before it
calls the model, which takes whole inputs and cuts each cell's piece from
them (as a data loader's batch on the host would be cut).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs import get_arch, get_shape
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data.lm import encoder_frames
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import MeshEnv
from repro_torch.models.model import Model, build_model
from repro_torch.train.optim import OptimizerConfig, build_optimizer
from repro_torch.train.trainer import make_train_step, shard_tree

# Optimizer-state memory policy: factored second moment above this many
# parameters (AdamW's 2x f32 state does not fit for the 100B+ cells).
ADAFACTOR_THRESHOLD = 50e9


@dataclasses.dataclass
class StepSpec:
    step: Callable               # step(*args): the cell's one step
    args: Tuple[Any, ...]        # its inputs, fake pieces on the grid
    static: Dict[str, Any]       # mode, optimizer


def make_inputs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Stand-ins for every model input of this cell, whole on the CPU
    (fake under ``FakeTensorMode``)."""
    b, s = shape.global_batch, shape.seq_len

    def embeds(n):
        return torch.empty((b, n, cfg.d_model), dtype=torch.float32)

    if shape.kind == "decode":     # one token against a cache of seq_len
        return {"token": torch.empty((b, 1), dtype=torch.int32),
                "pos": torch.empty((), dtype=torch.int32)}
    out = {"tokens": torch.empty((b, s), dtype=torch.int32)}
    if shape.kind == "train":
        out["labels"] = torch.empty((b, s), dtype=torch.int32)
    if cfg.family == "vlm" and cfg.n_patches:
        out["patch_embeds"] = embeds(min(cfg.n_patches, s))
    if cfg.is_encoder_decoder:
        out["frames"] = embeds(encoder_frames(cfg))
    return out


def pick_optimizer(params: Any) -> OptimizerConfig:
    """Adafactor for a parameter tree of more than ``ADAFACTOR_THRESHOLD``
    elements, else AdamW (JAX's ``pick_optimizer``, which counts the same
    tree from ``model.init``)."""
    if Model.param_count(params) > ADAFACTOR_THRESHOLD:
        return OptimizerConfig(name="adafactor")
    return OptimizerConfig(name="adamw")


def init_params(model: Model, *, cast: bool = False) -> Any:
    """The model's weights, drawn whole on the CPU from seed 0 (under
    ``FakeTensorMode``: shapes only; a card's generator cannot be faked on
    a host without one)."""
    return model.init(torch.Generator().manual_seed(0), cast=cast)


def shard_batch(batch: Dict[str, torch.Tensor], env: MeshEnv,
                seq_sharded: bool = True) -> Dict[str, Any]:
    """Each input cut into ``Sharded`` pieces by ``batch_specs``."""
    specs = sh.batch_specs(batch, env, seq_sharded=seq_sharded)
    return {k: sh.shard(v, specs[k], env) for k, v in batch.items()}


def join_batch(batch: Dict[str, Any], env: MeshEnv) -> Dict[str, Any]:
    """The inverse of :func:`shard_batch`: each input whole on the host,
    from which the model cuts each cell's piece."""
    return {k: sh.unshard(v, None, env, device="cpu")
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# per-mode step specs
# ---------------------------------------------------------------------------

def train_spec(cfg: ArchConfig, shape: ShapeConfig, env: MeshEnv, *,
               remat: bool = True) -> StepSpec:
    model = build_model(cfg)
    params = init_params(model)
    opt_cfg = pick_optimizer(params)
    opt_state = build_optimizer(opt_cfg)[0](params)
    step_fn = make_train_step(model, opt_cfg, remat=remat, env=env)
    args = (shard_tree(params, env), shard_tree(opt_state, env),
            torch.zeros((), dtype=torch.int32, device=env.first),
            shard_batch(make_inputs(cfg, shape), env))

    def step(params, opt_state, step_no, batch):
        return step_fn(params, opt_state, step_no, join_batch(batch, env))

    return StepSpec(step, args, {"optimizer": opt_cfg.name, "mode": "train"})


def prefill_spec(cfg: ArchConfig, shape: ShapeConfig, env: MeshEnv
                 ) -> StepSpec:
    model = build_model(cfg)
    params = shard_tree(init_params(model, cast=True), env)
    batch = shard_batch(make_inputs(cfg, shape), env)

    def step(params, batch):
        return model.prefill(params, join_batch(batch, env), env=env)

    return StepSpec(step, (params, batch), {"mode": "prefill"})


def decode_spec(cfg: ArchConfig, shape: ShapeConfig, env: MeshEnv
                ) -> StepSpec:
    model = build_model(cfg)
    params = shard_tree(init_params(model, cast=True), env)
    b = shape.global_batch
    caches = model.init_cache(b, shape.seq_len, env=env)
    inp = make_inputs(cfg, shape)
    token = shard_batch({"token": inp["token"]}, env, seq_sharded=False)
    pos = inp["pos"].to(env.first)

    def step(params, caches, token, pos):
        return model.decode_step(
            params, caches, join_batch(token, env)["token"], pos, env=env)

    return StepSpec(step, (params, caches, token, pos), {"mode": "decode"})


def make_spec(arch: Any, shape: Any, env: MeshEnv) -> StepSpec:
    """The cell's spec; ``arch`` and ``shape`` are names or configs.  A
    cell the arch does not run (``supports_shape``: full attention at
    500k) raises ``ValueError``."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = get_shape(shape) if isinstance(shape, str) else shape
    if not cfg.supports_shape(shape):
        raise ValueError(f"{cfg.name} skips {shape.name} "
                         f"(sub-quadratic attention required)")
    if shape.kind == "train":
        return train_spec(cfg, shape, env)
    if shape.kind == "prefill":
        return prefill_spec(cfg, shape, env)
    return decode_spec(cfg, shape, env)
