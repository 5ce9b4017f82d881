"""Dense decoder-only transformer: prefill and greedy decode.

The port of ``src/repro/models/model.py`` for stacks whose every layer is
an ``"attn"`` block (qwen3, smollm, gemma, qwen2.5): the same parameters,
the same math, the same cache layout (B, cache_len, KVH, hd) per layer.
Other block kinds, MoE, encoder–decoder and VLM patch embeddings are not
ported yet; :func:`build_model` refuses them and names the ROADMAP item.

Differences from the JAX model, all of form and none of result:
  * parameters are a dict with a Python list of per-layer dicts under
    ``"layers"`` (JAX stacks them on a leading axis and runs
    ``lax.scan``); the layer loop is plain Python;
  * ``cast_params`` casts the ≥2-D weights to the compute dtype ONCE, when
    the weights are loaded; ``prefill`` and ``decode_step`` take the cast
    parameters (JAX casts the float32 masters inside every call);
  * ``decode_step`` writes the new K/V into the caches in place and
    returns the same cache objects;
  * attention runs the flash and decode kernels, whose numerics are the
    Pallas kernels': probabilities stay float32 through P·V, where the
    jnp stand-in of the JAX model casts them to the value dtype first
    (``attention.py:112``).  The two agree to rounding in float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    mlp_apply,
    mlp_init,
    norm_apply,
    norm_init,
    rmsnorm,
)

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def cast_params(params: Params, dt: torch.dtype) -> Params:
    """Compute-dtype copies of the float32 master weights (≥2-D leaves);
    1-D leaves (norm scales, biases) stay float32.  Call once, when the
    weights are loaded."""
    def cast(x):
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        if isinstance(x, list):
            return [cast(v) for v in x]
        if x.dim() >= 2 and x.dtype == torch.float32 and dt != x.dtype:
            return x.to(dt)
        return x
    return cast(params)


def _attn_params(cfg: ArchConfig, gen: torch.Generator) -> Params:
    d, qd, kvd, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.hd
    dev = gen.device
    p = {
        "wq": dense_init(gen, d, qd),
        "wk": dense_init(gen, d, kvd),
        "wv": dense_init(gen, d, kvd),
        "wo": dense_init(gen, qd, d, scale=1.0 / math.sqrt(qd)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(qd, device=dev)
        p["bk"] = torch.zeros(kvd, device=dev)
        p["bv"] = torch.zeros(kvd, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(hd, device=dev)
        p["k_norm"] = torch.zeros(hd, device=dev)
    return p


def _layer_params(cfg: ArchConfig, gen: torch.Generator) -> Params:
    d = cfg.d_model
    return {"norm1": norm_init(cfg, d, gen.device),
            "attn": _attn_params(cfg, gen),
            "norm2": norm_init(cfg, d, gen.device),
            "mlp": mlp_init(cfg, gen, d, cfg.d_ff)}


def _qk_norm(cfg: ArchConfig, x: torch.Tensor, scale: torch.Tensor
             ) -> torch.Tensor:
    """Per-head RMSNorm (qwen3)."""
    return rmsnorm(x, scale, cfg.norm_eps)


def _attn_qkv(cfg: ArchConfig, p: Params, h: torch.Tensor,
              positions: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = h.shape
    dt = h.dtype
    q = h @ p["wq"]
    k = h @ p["wk"]
    v = h @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(b, s, cfg.n_heads, cfg.hd)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = _qk_norm(cfg, q, p["q_norm"])
        k = _qk_norm(cfg, k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _pad_cache(k: torch.Tensor, cache_len: int) -> torch.Tensor:
    s = k.shape[1]
    if s >= cache_len:
        return k[:, :cache_len].contiguous()
    out = k.new_zeros((k.shape[0], cache_len) + tuple(k.shape[2:]))
    out[:, :s] = k
    return out


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype(self.cfg)

    # --- init ---------------------------------------------------------------
    def init(self, gen: torch.Generator) -> Params:
        """Float32 master weights drawn from ``gen`` on ``gen.device``, with
        the JAX package's distributions: embeddings N(0, 0.02²), dense
        N(0, 1/d_in), ``wo`` N(0, 1/q_dim), norm and qk-norm scales 0."""
        cfg = self.cfg
        v, d = cfg.padded_vocab, cfg.d_model
        params: Params = {
            "embed": torch.randn((v, d), generator=gen,
                                 device=gen.device).mul_(0.02),
            "final_norm": norm_init(cfg, d, gen.device),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = torch.randn(
                (v, d), generator=gen, device=gen.device).mul_(0.02)
        params["layers"] = [_layer_params(cfg, gen)
                            for _ in range(cfg.n_layers)]
        return params

    def cast_params(self, params: Params) -> Params:
        """The parameters ``prefill`` and ``decode_step`` take: ≥2-D
        weights in the config's compute dtype (identity for float32)."""
        return cast_params(params, self.dtype)

    @staticmethod
    def param_count(params: Params) -> int:
        def count(x):
            if isinstance(x, dict):
                return sum(count(v) for v in x.values())
            if isinstance(x, list):
                return sum(count(v) for v in x)
            return x.numel()
        return count(params)

    # --- embedding / head ---------------------------------------------------
    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = params["embed"][tokens.long()]
        if cfg.scale_embeds:
            # JAX multiplies by sqrt(d) rounded to the compute dtype
            x = x * float(torch.tensor(math.sqrt(cfg.d_model),
                                       dtype=x.dtype))
        return x

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        w = params["embed"] if self.cfg.tie_embeddings else params["unembed"]
        return x @ w.t()

    def _layer(self, p: Params, x: torch.Tensor, positions: torch.Tensor,
               attend) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        b, s, _ = x.shape
        h = norm_apply(cfg, x, p["norm1"])
        q, k, v = _attn_qkv(cfg, p["attn"], h, positions)
        o = attend(q, k, v)
        x = x + o.reshape(b, s, cfg.q_dim) @ p["attn"]["wo"]
        h2 = norm_apply(cfg, x, p["norm2"])
        return x + mlp_apply(cfg, p["mlp"], h2), k, v

    # --- prefill -------------------------------------------------------------
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Forward over the prompt ``batch["tokens"]`` (B, S); returns
        (last-position logits (B, 1, padded_vocab) float32, caches), the
        caches one {"k", "v"} (B, cache_len, KVH, hd) per layer holding
        the prompt's K/V (default cache_len: S)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache_len = cache_len or s
        x = self._embed(params, tokens)
        positions = torch.arange(s, device=x.device)
        caches: Cache = []
        for p in params["layers"]:
            x, k, v = self._layer(
                p, x, positions,
                lambda q, k, v: attn.flash_attention_local(q, k, v,
                                                           causal=True))
            caches.append({"k": _pad_cache(k, cache_len),
                           "v": _pad_cache(v, cache_len)})
        x = norm_apply(self.cfg, x, params["final_norm"])
        return self._logits(params, x[:, -1:]).float(), caches

    # --- decode --------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int,
                   device: Union[str, torch.device]) -> Cache:
        cfg = self.cfg
        shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
        return [{"k": torch.zeros(shape, dtype=self.dtype, device=device),
                 "v": torch.zeros(shape, dtype=self.dtype, device=device)}
                for _ in range(cfg.n_layers)]

    def decode_step(self, params: Params, caches: Cache, token: torch.Tensor,
                    pos: Union[int, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Cache]:
        """token: (B, 1) int; pos: the new token's position, an int or a
        0-d int32 tensor on the device (read there: no host round trip).
        Writes the token's K/V into ``caches`` in place; returns (logits
        (B, 1, padded_vocab) float32, caches)."""
        x = self._embed(params, token)
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
        positions = pos.reshape(1)
        for p, c in zip(params["layers"], caches):
            x, _, _ = self._layer(
                p, x, positions,
                lambda q, k, v: attn.decode_attention(
                    q, c["k"], c["v"], k, v, pos)[0])
        x = norm_apply(self.cfg, x, params["final_norm"])
        return self._logits(params, x).float(), caches


def build_model(cfg: ArchConfig) -> Model:
    """A :class:`Model` for a dense all-``"attn"`` config; other families
    raise ``NotImplementedError`` naming the ROADMAP item that ports
    them."""
    kinds = set(cfg.layer_kinds())
    if kinds & {"m", "s"}:
        raise NotImplementedError(
            f"{cfg.name}: mLSTM/sLSTM blocks are not ported yet (ROADMAP.md "
            "Queue 1 item 2a, the sLSTM path)")
    if kinds - {"attn"}:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(kinds - {'attn'})} are not "
            "ported yet (ROADMAP.md Queue 1 item 2b, the remaining "
            "model families: the \"local\"/\"rec\" hybrid)")
    for flag, what in ((cfg.is_moe, "MoE"),
                       (cfg.is_encoder_decoder, "encoder–decoder"),
                       (cfg.n_patches > 0, "VLM patch embeddings")):
        if flag:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet (ROADMAP.md Queue 1 "
                "item 2b, the remaining model families)")
    return Model(cfg)
