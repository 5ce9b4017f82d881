"""Pipeline parallelism: GPipe microbatching over a mesh axis.

The port of ``src/repro/distributed/pipeline.py``.  ``pipeline_apply``
runs a layer stack split into S stages over the ``stage`` axis of a
``MeshEnv`` (one stage a cell, on that cell's device).  Microbatches
stream through the stages in the GPipe fill-drain schedule: at tick t,
stage s works on microbatch t - s and passes its activations to stage s +
1 on that stage's device; after S + M - 1 ticks every microbatch has
passed every stage in order.  The bubble fraction is (S - 1) / (S - 1 +
M), which ``pipeline_bubble`` reports so a launcher can size M.

The port is single-controller (``distributed/sharding.py``): one process
runs the ticks in order, so an idle tick (a stage whose microbatch has
not arrived or has left) is skipped, where JAX computes it on zeros and
discards it.  The output comes back in batch layout on the first cell's
device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.distributed.sharding import MeshEnv


def pipeline_bubble(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / max(n_stages - 1 + n_micro, 1)


def _to(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev)


def _stage_params(stage_params: Any, s: int, dev: torch.device) -> Any:
    """Stage s's slice of a tree with a leading stage axis, on ``dev``."""
    if isinstance(stage_params, dict):
        return {k: _stage_params(v, s, dev) for k, v in stage_params.items()}
    if isinstance(stage_params, tuple):
        return tuple(_stage_params(v, s, dev) for v in stage_params)
    return stage_params[s].to(dev)


def pipeline_apply(layer_fn: Callable, stage_params: Any, x: torch.Tensor,
                   *, env: MeshEnv, axis: str, n_micro: int) -> torch.Tensor:
    """Run ``layer_fn(params_stage, x_micro)`` through the S stages of
    ``axis``.

    stage_params: a tensor or a tree (dicts, tuples) of tensors with a
    leading stage axis of size S, as JAX takes it, or a Python list of S
    per-stage trees (the port keeps per-layer lists: stage s's layers
    need no stacking); stage s's part lives on the device of rank s along
    ``axis``.  x: (B, ...), split into ``n_micro`` microbatches of B /
    n_micro rows.  Returns y with x's shape, each microbatch having
    passed stages 0..S-1 in order, on the first cell's device."""
    s_count = env.size(axis)
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} is not divisible by n_micro {n_micro}")
    mb = b // n_micro
    devs = [env.cells[c] for c in env.group(0, axis)]
    if isinstance(stage_params, list):
        if len(stage_params) != s_count:
            raise ValueError(f"{len(stage_params)} stage trees for "
                             f"{s_count} stages")
        params = [_to(p, devs[s]) for s, p in enumerate(stage_params)]
    else:
        params = [_stage_params(stage_params, s, devs[s])
                  for s in range(s_count)]
    micros = x.split(mb, dim=0)
    held: Dict[int, torch.Tensor] = {}        # stage -> its input this tick
    out = [None] * n_micro
    for t in range(n_micro + s_count - 1):
        if t < n_micro:
            held[0] = micros[t].to(devs[0])
        done: Dict[int, torch.Tensor] = {}
        for s in range(s_count):
            mi = t - s
            if 0 <= mi < n_micro:
                done[s] = layer_fn(params[s], held[s])
        held = {}
        for s, y in done.items():
            if s == s_count - 1:
                out[t - s] = y
            else:
                held[s + 1] = y.to(devs[s + 1])
    return torch.cat([y.to(env.first) for y in out], dim=0)
