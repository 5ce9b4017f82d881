"""Weights carried across from the JAX package.

``params_from_jax`` turns the JAX model's parameter pytree, with numpy
leaves (``jax.tree.map(np.asarray, params)`` on the JAX side), into this
port's parameters: the per-layer leaves stacked on a leading axis under
``params["stack"]["0_attn"]`` become a list of per-layer dicts, and every
weight keeps its ``(d_in, d_out)`` orientation.  The same weights give the
same logits; the tests use it to hold the port to the JAX model.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import Params, build_model


def _to_torch(tree: Any, index=None) -> Any:
    if isinstance(tree, Mapping):
        return {k: _to_torch(v, index) for k, v in tree.items()}
    a = np.asarray(tree)
    if index is not None:
        a = a[index]
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(cfg: ArchConfig, tree: Mapping[str, Any]) -> Params:
    """The port's float32 master parameters, on the CPU, from a JAX
    parameter tree of numpy arrays (dense all-``"attn"`` configs only, as
    ``build_model``)."""
    build_model(cfg)
    stack = tree["stack"]["0_attn"]
    n = np.asarray(stack["norm1"]["scale"]).shape[0]
    if n != cfg.n_layers or tree.get("tail"):
        raise ValueError(f"expected {cfg.n_layers} stacked 'attn' layers "
                         f"and no tail, got {n} and {sorted(tree.get('tail') or {})}")
    params: Params = {
        "embed": _to_torch(tree["embed"]),
        "final_norm": _to_torch(tree["final_norm"]),
        "layers": [_to_torch(stack, i) for i in range(n)],
    }
    if "unembed" in tree:
        params["unembed"] = _to_torch(tree["unembed"])
    return params
