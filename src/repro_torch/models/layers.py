"""Shared layer primitives: norms, RoPE, projections, MLPs, init.

The port of ``src/repro/models/layers.py``: the same functions on torch
tensors, with a ``torch.Generator`` in place of a PRNG key.  Weights keep
the JAX package's ``(d_in, d_out)`` orientation, so ``x @ w``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    """RMSNorm with the ``(1 + scale)`` form, in float32."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    out = (x - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(dt)


def norm_apply(cfg: ArchConfig, x: torch.Tensor, p: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(x, p["scale"], cfg.norm_eps)


def norm_init(cfg: ArchConfig, d: int, device) -> Dict[str, torch.Tensor]:
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}
    return {"scale": torch.zeros(d, device=device)}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = -torch.arange(0, hd // 2, dtype=torch.float32,
                         device=device) / (hd // 2)
    # a Python scalar base: no host-to-device copy on a CUDA decode step
    return torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (S,) or (..., S) token positions.
    The split-halves form, in float32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)           # (hd//2,)
    angles = positions[..., :, None].float() * freqs        # (..., S, hd//2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """(seq, d) float32 sinusoidal position embeddings (the encoder's):
    sin at the even columns, cos at the odd ones, of pos / 10000^(2i/d)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, dim / d)
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle[:, :d // 2])
    return pe


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None) -> torch.Tensor:
    """N(0, scale²) of shape (d_in, d_out), scale 1/√d_in by default, drawn
    on ``gen.device``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device)
    return w.mul_(scale)


def act_fn(name: str):
    """SiLU, or GELU in its tanh form (``jax.nn.gelu``'s default)."""
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise KeyError(name)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_init(cfg: ArchConfig, gen: torch.Generator, d: int, d_ff: int
             ) -> Dict[str, torch.Tensor]:
    return {
        "w_gate": dense_init(gen, d, d_ff),
        "w_up": dense_init(gen, d, d_ff),
        "w_down": dense_init(gen, d_ff, d),
    }


def mlp_apply(cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> torch.Tensor:
    """Weights must already be in x's dtype (see ``Model.cast_params``)."""
    return glu(cfg, x @ p["w_gate"], x @ p["w_up"]) @ p["w_down"]


def glu(cfg: ArchConfig, gate: torch.Tensor, up: torch.Tensor
        ) -> torch.Tensor:
    """The gated MLP's middle, act(gate)·up, from its two products."""
    return act_fn(cfg.act)(gate) * up
