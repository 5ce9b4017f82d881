"""Decoder-only language models: prefill and greedy decode.

The port of ``src/repro/models/model.py`` for stacks built of the block
kinds ported so far: ``"attn"`` (the dense transformers: qwen3, smollm,
gemma, qwen2.5) and the xLSTM blocks ``"m"`` (mLSTM) and ``"s"`` (sLSTM),
in any pattern (xlstm-1.3b: seven ``"m"`` then one ``"s"``).  The same
parameters, the same math, the same per-kind caches: {"k", "v"}
(B, cache_len, KVH, hd) for ``"attn"``, {"c", "n"} for ``"m"``,
{"c", "n", "h", "m"} for ``"s"``.  The other kinds (``"local"``,
``"rec"``), MoE, encoder–decoder and VLM patch embeddings are not ported
yet; :func:`build_model` refuses them and names the ROADMAP item.

Differences from the JAX model, all of form and none of result:
  * parameters are a dict with a Python list of per-layer dicts under
    ``"layers"``, one per layer in layer order (JAX stacks each kind of
    the block pattern on a leading axis and runs ``lax.scan`` over the
    pattern groups); the layer loop is plain Python;
  * ``cast_params`` casts to the compute dtype ONCE, when the weights are
    loaded, the leaves JAX casts inside every call: those ≥2-D in JAX's
    stacked layout (every leaf of a layer in a pattern group, the sLSTM's
    ``r_mat`` among them; ≥2-D leaves of the tail and the top level);
  * ``decode_step`` writes the new K/V into the attention caches in place,
    puts the new recurrent states into the caches' dicts, and returns the
    same cache objects;
  * attention runs the flash and decode kernels, whose numerics are the
    Pallas kernels': probabilities stay float32 through P·V, where the
    jnp stand-in of the JAX model casts them to the value dtype first
    (``attention.py:112``).  The two agree to rounding in float32;
  * the sLSTM runs the scan kernel once per layer and prefill, which
    returns the final state from the same pass (JAX runs the scan twice).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.slstm_scan.ref import M_INIT
from repro_torch.models import attention as attn
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    mlp_apply,
    mlp_init,
    norm_apply,
    norm_init,
)

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def cast_params(params: Params, dt: torch.dtype, n_stacked: int = 0
                ) -> Params:
    """Compute-dtype copies of the float32 master weights: the leaves JAX's
    ``cast_params`` casts, every one that is ≥2-D in JAX's layout.  JAX
    stacks the layers of its pattern groups on a leading axis, so there
    every leaf of the first ``n_stacked`` layers is ≥2-D and is cast, norm
    scales and biases included; the 1-D leaves of the unrolled tail and
    of the top level (``final_norm``) stay float32.  Call once, when the
    weights are loaded."""
    def cast(x, min_dim):
        if isinstance(x, dict):
            return {k: cast(v, min_dim) for k, v in x.items()}
        if x.dim() >= min_dim and x.dtype == torch.float32 and dt != x.dtype:
            return x.to(dt)
        return x
    out = {k: cast(v, 2) for k, v in params.items() if k != "layers"}
    out["layers"] = [cast(p, 1 if i < n_stacked else 2)
                     for i, p in enumerate(params["layers"])]
    return out


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


def _layer_params(cfg: ArchConfig, kind: str, gen: torch.Generator
                  ) -> Params:
    """One layer's float32 master weights, with the JAX initialisers
    (``model.py:99``)."""
    d = cfg.d_model
    dev = gen.device
    p: Params = {"norm1": norm_init(cfg, d, dev)}
    if kind == "attn":
        p["attn"] = _attn_params(cfg, gen)
        p["norm2"] = norm_init(cfg, d, dev)
        p["mlp"] = mlp_init(cfg, gen, d, cfg.d_ff)
    elif kind == "m":
        # mLSTM block: qkv + output projections + per-head i/f gates
        h = cfg.n_heads
        for name in ("wq", "wk", "wv", "wo"):
            p[name] = dense_init(gen, d, d)
        p["w_if"] = dense_init(gen, d, 2 * h)        # input & forget gates
        p["b_if"] = torch.cat([torch.zeros(h, device=dev),
                               torch.full((h,), 3.0, device=dev)])
    elif kind == "s":
        # sLSTM block: z/i/f/o pre-activations + block-diagonal recurrent R
        h, hd = cfg.n_heads, d // cfg.n_heads
        p["w_zifo"] = dense_init(gen, d, 4 * d)
        p["b_zifo"] = torch.zeros((4, h, hd), device=dev)
        p["r_mat"] = torch.randn((h, hd, 4 * hd), generator=gen,
                                 device=dev).mul_(hd ** -0.5)
        p["wo"] = dense_init(gen, d, d)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    return p


def _qk_norm(cfg: ArchConfig, x: torch.Tensor, scale: torch.Tensor
             ) -> torch.Tensor:
    """Per-head RMSNorm (qwen3).  Unlike ``rmsnorm``, JAX adds 1 to the
    scale in the scale's own dtype (bf16 once cast, ``model.py:159``)."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + cfg.norm_eps)
            * (1.0 + scale).float()).to(dt)


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

    @property
    def kinds(self) -> Tuple[str, ...]:
        """The block kind of every layer, in layer order."""
        return self.cfg.layer_kinds()

    # --- init ---------------------------------------------------------------
    def init(self, gen: torch.Generator) -> Params:
        """Float32 master weights drawn from ``gen`` on ``gen.device``, with
        the JAX package's distributions: embeddings N(0, 0.02²), dense
        N(0, 1/d_in), attention ``wo`` N(0, 1/q_dim), norm and qk-norm
        scales 0, the mLSTM gate bias [0…, 3…], the sLSTM ``r_mat``
        N(0, 1/hd) and ``b_zifo`` 0."""
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
        params["layers"] = [_layer_params(cfg, kind, gen)
                            for kind in self.kinds]
        return params

    def cast_params(self, params: Params) -> Params:
        """The parameters ``prefill`` and ``decode_step`` take: the leaves
        JAX casts in the config's compute dtype (identity for float32)."""
        cfg = self.cfg
        period = len(cfg.block_pattern)
        return cast_params(params, self.dtype,
                           cfg.n_layers // period * period)

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

    # --- layers -------------------------------------------------------------
    def _attn_layer(self, p: Params, x: torch.Tensor,
                    positions: torch.Tensor, attend
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        b, s, _ = x.shape
        h = norm_apply(cfg, x, p["norm1"])
        q, k, v = _attn_qkv(cfg, p["attn"], h, positions)
        o = attend(q, k, v)
        x = x + o.reshape(b, s, cfg.q_dim) @ p["attn"]["wo"]
        h2 = norm_apply(cfg, x, p["norm2"])
        return x + mlp_apply(cfg, p["mlp"], h2), k, v

    def _mlstm_inputs(self, p: Params, x: torch.Tensor):
        """q, k, v (B, S, H, hd) and the raw i/f gates (B, S, H) of an
        mLSTM block, from x (B, S, d)."""
        cfg = self.cfg
        b, s, d = x.shape
        hn = cfg.n_heads
        h = norm_apply(cfg, x, p["norm1"])
        q, k, v = ((h @ p[w]).reshape(b, s, hn, d // hn)
                   for w in ("wq", "wk", "wv"))
        gates = h @ p["w_if"] + p["b_if"].to(x.dtype)
        i_raw, f_raw = gates.split(hn, dim=-1)
        return q, k, v, i_raw, f_raw

    def _slstm_inputs(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        """The sLSTM pre-activations (B, S, 4, H, hd), in x's dtype."""
        cfg = self.cfg
        b, s, d = x.shape
        hn = cfg.n_heads
        h = norm_apply(cfg, x, p["norm1"])
        pre = (h @ p["w_zifo"]).reshape(b, s, 4, hn, d // hn)
        return pre + p["b_zifo"].to(x.dtype)

    # --- prefill -------------------------------------------------------------
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Forward over the prompt ``batch["tokens"]`` (B, S); returns
        (last-position logits (B, 1, padded_vocab) float32, caches): one
        dict per layer, {"k", "v"} (B, cache_len, KVH, hd) holding the
        prompt's K/V (default cache_len: S) for ``"attn"``, the final
        recurrent state for ``"m"`` and ``"s"`` (which ignore
        ``cache_len``)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache_len = cache_len or s
        x = self._embed(params, tokens)
        d = x.shape[-1]
        positions = torch.arange(s, device=x.device)
        caches: Cache = []
        for kind, p in zip(self.kinds, params["layers"]):
            if kind == "attn":
                x, k, v = self._attn_layer(
                    p, x, positions,
                    lambda q, k, v: attn.flash_attention_local(q, k, v,
                                                               causal=True))
                caches.append({"k": _pad_cache(k, cache_len),
                               "v": _pad_cache(v, cache_len)})
            elif kind == "m":
                o, (c, n) = rec.mlstm_with_state(*self._mlstm_inputs(p, x))
                x = x + o.reshape(b, s, d) @ p["wo"]
                caches.append({"c": c, "n": n})
            else:
                o, st = rec.slstm_with_state(self._slstm_inputs(p, x),
                                             p["r_mat"])
                x = x + o.reshape(b, s, d) @ p["wo"]
                caches.append(dict(zip(("c", "n", "h", "m"), st)))
        x = norm_apply(self.cfg, x, params["final_norm"])
        return self._logits(params, x[:, -1:]).float(), caches

    # --- decode --------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int,
                   device: Union[str, torch.device]) -> Cache:
        """Empty caches, one dict per layer, as JAX's ``_layer_cache``
        (``model.py:263``): zero K/V, zero (c, n) and, for ``"s"``, zero
        h and m = -1e30."""
        cfg = self.cfg
        hn, hdm = cfg.n_heads, cfg.d_model // cfg.n_heads
        caches: Cache = []
        for kind in self.kinds:
            if kind == "attn":
                shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
                caches.append({
                    "k": torch.zeros(shape, dtype=self.dtype, device=device),
                    "v": torch.zeros(shape, dtype=self.dtype, device=device)})
                continue
            z = torch.zeros((batch, hn, hdm), device=device)
            if kind == "m":
                caches.append({"c": torch.zeros((batch, hn, hdm, hdm),
                                                device=device), "n": z})
            else:
                caches.append({"c": z, "n": z.clone(), "h": z.clone(),
                               "m": torch.full_like(z, M_INIT)})
        return caches

    def decode_step(self, params: Params, caches: Cache, token: torch.Tensor,
                    pos: Union[int, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Cache]:
        """token: (B, 1) int; pos: the new token's position, an int or a
        0-d int32 tensor on the device (read there: no host round trip;
        the recurrent layers ignore it).  Writes the token's K/V into the
        attention caches in place and the new recurrent states into their
        caches' dicts; returns (logits (B, 1, padded_vocab) float32,
        caches)."""
        x = self._embed(params, token)
        b, _, d = x.shape
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
        positions = pos.reshape(1)
        for kind, p, c in zip(self.kinds, params["layers"], caches):
            if kind == "attn":
                x, _, _ = self._attn_layer(
                    p, x, positions,
                    lambda q, k, v: attn.decode_attention(
                        q, c["k"], c["v"], k, v, pos)[0])
            elif kind == "m":
                q, k, v, i_raw, f_raw = (
                    t[:, 0] for t in self._mlstm_inputs(p, x))
                (c["c"], c["n"]), o = rec.mlstm_decode_step(
                    (c["c"], c["n"]), q, k, v, i_raw, f_raw)
                x = x + (o.reshape(b, d) @ p["wo"])[:, None]
            else:
                st = (c["c"], c["n"], c["h"], c["m"])
                (c["c"], c["n"], c["h"], c["m"]), o = rec.slstm_decode_step(
                    st, self._slstm_inputs(p, x)[:, 0], p["r_mat"])
                x = x + (o.reshape(b, d) @ p["wo"])[:, None]
        x = norm_apply(self.cfg, x, params["final_norm"])
        return self._logits(params, x).float(), caches


PORTED_KINDS = ("attn", "m", "s")


def build_model(cfg: ArchConfig) -> Model:
    """A :class:`Model` for a stack of ``"attn"``, ``"m"`` and ``"s"``
    layers; the other kinds and families raise ``NotImplementedError``
    naming the ROADMAP item that ports them."""
    kinds = set(cfg.layer_kinds())
    if kinds - set(PORTED_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(kinds - set(PORTED_KINDS))} "
            f"are not ported yet (ported: {list(PORTED_KINDS)}; ROADMAP.md "
            "Queue 1 item 2b, the remaining model families: the "
            "\"local\"/\"rec\" hybrid)")
    for flag, what in ((cfg.is_moe, "MoE"),
                       (cfg.is_encoder_decoder, "encoder–decoder"),
                       (cfg.n_patches > 0, "VLM patch embeddings")):
        if flag:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet (ROADMAP.md Queue 1 "
                "item 2b, the remaining model families)")
    return Model(cfg)
