"""Weights carried across from the JAX package.

``params_from_jax`` turns the JAX model's parameter pytree, with numpy
leaves (``jax.tree.map(np.asarray, params)`` on the JAX side), into this
port's parameters.  JAX stacks the layers of each position of the block
pattern on a leading axis: layer ``g * period + j`` of kind ``kind`` is
``tree["stack"][f"{j}_{kind}"][g]``, and the unrolled tail's layer
``n_groups * period + j`` is ``tree["tail"][f"{j}_{kind}"]`` (a dense
stack is the case period 1, ``"0_attn"``, no tail; recurrentgemma's 38
layers are 12 groups of ``("0_rec", "1_rec", "2_local")`` and a tail of
``("0_rec", "1_rec")``).  The encoder–decoder's ``enc_stack`` and
``cross_stack`` are stacked the same way, one entry per layer.  The port
keeps one dict per layer, in layer order (``"layers"``, ``"enc_layers"``,
``"cross_layers"``), and every weight its ``(d_in, d_out)``
orientation.  The same weights give the same logits; the tests use it to
hold the port to the JAX model.  Any parameter-shaped tree maps the same
way (JAX's gradients, AdamW's ``m`` and ``v``); ``opt_state_from_jax``
maps a whole optimizer state, Adafactor's per-leaf (vr, vc) or (v,)
tuples included (a checkpoint restores them as lists).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import Params, build_model


def _to_torch(tree: Any, index=None) -> Any:
    if isinstance(tree, Mapping):
        return {k: _to_torch(v, index) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_to_torch(v, index) for v in tree)
    a = np.asarray(tree)
    if index is not None:
        a = a[index]
    return torch.from_numpy(np.array(a, copy=True))


def _depth(tree: Any) -> int:
    """The leading (stacked) size of a JAX pytree's leaves."""
    while isinstance(tree, (Mapping, tuple, list)):
        tree = next(iter(tree.values())) if isinstance(tree, Mapping) \
            else tree[0]
    return np.asarray(tree).shape[0]


def params_from_jax(cfg: ArchConfig, tree: Mapping[str, Any]) -> Params:
    """The port's float32 master parameters, on the CPU, from a JAX
    parameter tree of numpy arrays (the configs ``build_model`` takes)."""
    build_model(cfg)
    pattern = cfg.block_pattern
    period = len(pattern)
    n_groups = cfg.n_layers // period
    tail = pattern[:cfg.n_layers % period]
    stack = tree.get("stack") or {}
    want = {f"{j}_{kind}" for j, kind in enumerate(pattern)} \
        if n_groups else set()
    got = {k: _depth(v) for k, v in stack.items()}
    if set(got) != want or any(n != n_groups for n in got.values()):
        raise ValueError(f"expected {n_groups} stacked groups of "
                         f"{sorted(want)}, got {got}")
    tail_tree = tree.get("tail") or {}
    if set(tail_tree) != {f"{j}_{kind}" for j, kind in enumerate(tail)}:
        raise ValueError(f"expected a tail of {list(tail)}, got "
                         f"{sorted(tail_tree)}")
    layers = [_to_torch(stack[f"{j}_{kind}"], g)
              for g in range(n_groups) for j, kind in enumerate(pattern)]
    layers += [_to_torch(tail_tree[f"{j}_{kind}"])
               for j, kind in enumerate(tail)]
    params: Params = {
        "embed": _to_torch(tree["embed"]),
        "final_norm": _to_torch(tree["final_norm"]),
        "layers": layers,
    }
    if "unembed" in tree:
        params["unembed"] = _to_torch(tree["unembed"])
    if cfg.is_encoder_decoder:
        for key, name, n in (("enc_stack", "enc_layers",
                              cfg.n_encoder_layers),
                             ("cross_stack", "cross_layers", cfg.n_layers)):
            if _depth(tree[key]) != n:
                raise ValueError(f"expected {n} stacked layers in {key}, "
                                 f"got {_depth(tree[key])}")
            params[name] = [_to_torch(tree[key], i) for i in range(n)]
        params["enc_norm"] = _to_torch(tree["enc_norm"])
    return params


def opt_state_from_jax(cfg: ArchConfig, name: str, tree: Mapping[str, Any]
                       ) -> Dict[str, Any]:
    """The port's optimizer state from JAX's (numpy leaves): for
    ``"adamw"`` {"m", "v"}, each a parameter-shaped tree; for
    ``"adafactor"`` {"s"}, a parameter-shaped tree of (vr, vc) or (v,)
    tuples, each entry split along the stacked axis as its parameter
    is."""
    if name == "adamw":
        return {k: params_from_jax(cfg, tree[k]) for k in ("m", "v")}
    if name == "adafactor":
        return {"s": params_from_jax(cfg, tree["s"])}
    raise ValueError(f"unknown optimizer {name!r}")
