"""Language models: the training loss, prefill and greedy decode.

The port of ``src/repro/models/model.py`` for every family: stacks of
the block kinds ``"attn"`` (the dense transformers: qwen3, smollm,
gemma, qwen2.5; with a Mixture-of-Experts FFN, ``moe.py``, for
qwen3-moe and llama4-scout), ``"local"`` (sliding-window attention) and
``"rec"`` (the Griffin recurrent block: conv4 + RG-LRU; recurrentgemma's
(rec, rec, local) pattern), the xLSTM blocks ``"m"`` (mLSTM) and ``"s"``
(sLSTM), in any pattern; the VLM's precomputed patch embeddings spliced
over the first positions (llava-next); and the encoder–decoder (whisper:
a bidirectional encoder over stub frame embeddings, then decoder layers
of self-attention, cross-attention and FFN).  The same parameters, the
same math, the same per-kind caches: {"k", "v"} (B, cache_len, KVH, hd)
for ``"attn"``, the rolling window {"k", "v"} (B, W, KVH, hd) with the
global position of each slot {"kpos"} (W,) (-1 = empty) for ``"local"``,
{"h", "tail"} for ``"rec"``, {"c", "n"} for ``"m"``, {"c", "n", "h",
"m"} for ``"s"``; an encoder–decoder layer adds its cross K/V
{"cross_k", "cross_v"} (B, F, KVH, hd) to its {"k", "v"}.  An MoE
layer's FFN is ``moe_dispatch`` in prefill and ``moe_decode`` in a
decode step, plus the shared experts' MLP where the config has them, as
in JAX.

``loss`` is the training path (JAX's ``Model.loss``, ``model.py:555``):
teacher-forced next-token NLL, differentiable.  Its layers follow JAX's
``_layer_seq``: attention through ``attention.ring_attention`` (JAX's
jnp flash math, each KV chunk recomputed in the backward), the sLSTM
through ``recurrent.slstm_train`` (the float32 step loop), the MoE FFN's
aux loss added in.  No kernel of the port runs in ``loss``: the JAX
package has no backward kernel to port, and the kernels' outputs carry
no gradient (their wrappers refuse inputs that require grad).

On a grid (``env``, a ``distributed.sharding.MeshEnv``): ``prefill``,
``decode_step``, ``loss`` and ``init_cache`` lay the activations out as
JAX constrains them (``model.py:485, 566, 605``): after the embedding,
one piece per cell, the batch over ``data`` and the sequence over
``model``; a decode step's token rows over ``data``, whole over
``model``.  In the prefill and the loss each layer's weights come
through ``gather_for_compute`` (whole on each distinct device, no copy
where a device holds them whole already; the expert tensors stay in
their pieces), as JAX gathers them there (``model.py:456``); a decode
step is weight-stationary, as JAX's is (``model.py:787-791``): each cell
multiplies by its own pieces (``sharding.sharded_dot``) and only
activations cross the grid (``_grid_decode``).  Attention runs the ring
(prefill, training) and the split-K decode over the cache shards, the
recurrent layers their prefix or carry chain, MoE its expert-parallel
dispatch.  The head follows ``_logits`` (``model.py:434-447``): the
vocabulary over ``model``, each cell's slice of the logits from its rows
of the unembedding, joined by rank (the loss: a log-sum-exp over the
slices).  Caches are :class:`~repro_torch.distributed.sharding.Sharded`
pieces by ``cache_specs`` (``gather_caches`` joins them whole); the
parameters may be whole tensors or pieces (``Sharded``, as the grid
``Trainer`` holds them and ``sharding.pieces`` cuts them once before a
decode loop).

Differences from the JAX model, all of form and none of result:
  * parameters are a dict with a Python list of per-layer dicts under
    ``"layers"``, one per layer in layer order (JAX stacks each kind of
    the block pattern on a leading axis and runs ``lax.scan`` over the
    pattern groups), and, for the encoder–decoder, ``"enc_layers"`` and
    ``"cross_layers"`` (JAX's ``enc_stack`` and ``cross_stack``); the
    layer loop is plain Python;
  * ``cast_params`` casts to the compute dtype ONCE, when the weights are
    loaded, the leaves JAX casts inside every call: those ≥2-D in JAX's
    stacked layout (every leaf of a layer in a pattern group, the
    encoder and the cross layers, the sLSTM's ``r_mat`` among them; ≥2-D
    leaves of the tail and the top level);
  * ``decode_step`` writes the new K/V into the attention caches in place,
    puts the new recurrent states into the caches' dicts, and returns the
    same cache objects; the cross K/V of the encoder–decoder live in each
    decoder layer's cache (JAX keeps them stacked under ``"enc_kv"``);
  * attention runs the flash and decode kernels, whose numerics are the
    Pallas kernels': probabilities stay float32 through P·V, where the
    jnp stand-in of the JAX model casts them to the value dtype first
    (``attention.py:112``).  The two agree to rounding in float32.
    ``"local"`` decode, cross attention and the RG-LRU are plain torch,
    as they are plain jnp in JAX;
  * the sLSTM runs the scan kernel once per layer and prefill, which
    returns the final state from the same pass (JAX runs the scan twice);
  * a ``"rec"`` layer's conv tail after a prompt of fewer than 3 tokens
    is zero-padded on the left to 3 rows (JAX keeps the short slice,
    whose decode step then fails).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.data.lm import encoder_frames
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import P, MeshEnv
from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.kernels.slstm_scan.ref import M_INIT
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import recurrent as rec
from repro_torch.models.layers import (
    act_fn,
    apply_rope,
    dense_init,
    glu,
    mlp_apply,
    mlp_init,
    norm_apply,
    norm_init,
    sinusoidal_positions,
)

Params = Dict[str, Any]
Cache = List[Dict[str, torch.Tensor]]

# per-layer lists that JAX stacks on a leading axis whatever their kind
STACKED_LISTS = ("enc_layers", "cross_layers")
# tokens whose float32 logits ``loss`` holds at a time
HEAD_CHUNK = 2048


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _cast(tree: Any, dt: torch.dtype, min_dim: int) -> Any:
    """``tree``'s float32 leaves of at least ``min_dim`` dimensions in
    ``dt``."""
    if isinstance(tree, dict):
        return {k: _cast(v, dt, min_dim) for k, v in tree.items()}
    if isinstance(tree, sh.Sharded):          # a leaf's pieces
        made: Dict[int, torch.Tensor] = {}
        for t in tree:
            if id(t) not in made:
                made[id(t)] = _cast(t, dt, min_dim)
        return sh.Sharded([made[id(t)] for t in tree], tree.spec)
    if isinstance(tree, list):
        return [_cast(v, dt, min_dim) for v in tree]
    if tree.dim() >= min_dim and tree.dtype == torch.float32 and \
            dt != tree.dtype:
        return tree.to(dt)
    return tree


def cast_params(params: Params, dt: torch.dtype, n_stacked: int = 0
                ) -> Params:
    """Compute-dtype copies of the float32 master weights: the leaves JAX's
    ``cast_params`` casts, every one that is ≥2-D in JAX's layout.  JAX
    stacks the layers of its pattern groups on a leading axis, so there
    every leaf of the first ``n_stacked`` layers is ≥2-D and is cast, norm
    scales and biases included, as is every leaf of the encoder and cross
    layers (``STACKED_LISTS``); the 1-D leaves of the unrolled tail and
    of the top level (``final_norm``, ``enc_norm``) stay float32.  Call
    once, when the weights are loaded."""
    out = {k: _cast(v, dt, 1 if k in STACKED_LISTS else 2)
           for k, v in params.items() if k != "layers"}
    out["layers"] = [_cast(p, dt, 1 if i < n_stacked else 2)
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


def _layer_params(cfg: ArchConfig, kind: str, gen: torch.Generator,
                  moe_dtype: torch.dtype = torch.float32) -> Params:
    """One layer's float32 master weights, with the JAX initialisers
    (``model.py:99``); an MoE layer's ``"moe"`` tensors are cast to
    ``moe_dtype`` as each is drawn (all of them are matrices, which
    ``cast_params`` casts)."""
    d = cfg.d_model
    dev = gen.device
    p: Params = {"norm1": norm_init(cfg, d, dev)}
    if kind in ("attn", "local"):
        p["attn"] = _attn_params(cfg, gen)
        p["norm2"] = norm_init(cfg, d, dev)
        if cfg.is_moe:
            p["moe"] = moe.moe_init(cfg, gen, moe_dtype)
            if cfg.n_shared_experts:
                p["shared_mlp"] = mlp_init(
                    cfg, gen, d, cfg.d_ff_expert * cfg.n_shared_experts)
        else:
            p["mlp"] = mlp_init(cfg, gen, d, cfg.d_ff)
    elif kind == "rec":
        # Griffin recurrent block: gate and recurrent input projections,
        # conv4, RG-LRU gates, output projection, then its own MLP
        p["proj_gate"] = dense_init(gen, d, d)
        p["proj_in"] = dense_init(gen, d, d)
        p["conv_w"] = torch.randn((4, d), generator=gen,
                                  device=dev).mul_(0.1)
        p["conv_b"] = torch.zeros(d, device=dev)
        p["w_rg"] = dense_init(gen, d, d)
        p["b_rg"] = torch.zeros(d, device=dev)
        p["w_ig"] = dense_init(gen, d, d)
        p["b_ig"] = torch.zeros(d, device=dev)
        p["lam"] = torch.full((d,), 0.7, device=dev)   # a ≈ 0.96^c init
        p["wo"] = dense_init(gen, d, d)
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
              positions: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v of an attention layer; RoPE at ``positions`` unless None
    (the encoder's layers)."""
    return _qkv_heads(cfg, p, h @ p["wq"], h @ p["wk"], h @ p["wv"],
                      positions)


def _qkv_heads(cfg: ArchConfig, p: Params, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, positions: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_attn_qkv`` from the projections q, k, v (B, S, ·): the biases,
    the heads, qk-norm and RoPE (``p`` needs only the 1-D leaves)."""
    b, s, _ = q.shape
    dt = q.dtype
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
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mlstm_heads(cfg: ArchConfig, p: Params, q: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, gates: torch.Tensor):
    """``Model._mlstm_inputs`` from the products q, k, v (B, S, d) and
    gates (B, S, 2H): the heads and the gates' bias (``p`` needs only
    ``b_if``)."""
    b, s, d = q.shape
    hn = cfg.n_heads
    q, k, v = (t.reshape(b, s, hn, d // hn) for t in (q, k, v))
    i_raw, f_raw = (gates + p["b_if"].to(gates.dtype)).split(hn, dim=-1)
    return q, k, v, i_raw, f_raw


def _slstm_heads(cfg: ArchConfig, p: Params, pre: torch.Tensor
                 ) -> torch.Tensor:
    """``Model._slstm_inputs`` from the product pre (B, S, 4d): the heads
    and the bias (``p`` needs only ``b_zifo``)."""
    b, s, d4 = pre.shape
    hn = cfg.n_heads
    return (pre.reshape(b, s, 4, hn, d4 // (4 * hn))
            + p["b_zifo"].to(pre.dtype))


def _refuse_ragged(env: MeshEnv, batch: Dict[str, torch.Tensor]) -> None:
    """Raise ``ValueError`` where the grid's ``model`` axis does not divide
    the sequence (dim 1) of ``batch``'s tokens or the encoder's frames,
    which the grid cuts over ``model``, as JAX's ``shard_map`` over the
    ring (``attention.py:216-222``) refuses it: its ranks would hold
    pieces of unequal length."""
    n = env.tp_size
    for name in ("tokens", "frames"):
        t = batch.get(name)
        if n > 1 and t is not None and t.shape[1] % n:
            raise ValueError(
                f"{name}: a sequence of length {t.shape[1]} is not "
                f"divisible by the grid's 'model' axis of size {n}")


def _pad_cache(k: torch.Tensor, cache_len: int) -> torch.Tensor:
    s = k.shape[1]
    if s >= cache_len:
        return k[:, :cache_len].contiguous()
    out = k.new_zeros((k.shape[0], cache_len) + tuple(k.shape[2:]))
    out[:, :s] = k
    return out


def _window_cache(k: torch.Tensor, v: torch.Tensor, window: int,
                  cache_len: int) -> Dict[str, torch.Tensor]:
    """The rolling-window cache a ``"local"`` layer leaves after a prompt
    (``model.py:646``): the last min(W, S) keys at their ``pos % W``
    slots, W = min(window, cache_len), so decode writes continue the
    ring."""
    b, s = k.shape[:2]
    w = min(window, cache_len)
    keep = min(w, s)
    kpos = torch.arange(s - keep, s, device=k.device)
    idx = kpos % w
    cache = {}
    for name, t in (("k", k), ("v", v)):
        ring = t.new_zeros((b, w) + tuple(t.shape[2:]))
        ring[:, idx] = t[:, s - keep:]
        cache[name] = ring
    kp = torch.full((w,), -1, dtype=torch.int32, device=k.device)
    kp[idx] = kpos.to(torch.int32)
    cache["kpos"] = kp
    return cache


def _conv_tail(xin: torch.Tensor) -> torch.Tensor:
    """The last 3 rows of the recurrent branch's input (B, S, dr) in
    float32, zero-padded on the left when S < 3."""
    tail = xin[:, -3:].to(torch.float32, copy=True)   # no view of xin
    if tail.shape[1] < 3:
        tail = torch.cat([tail.new_zeros((tail.shape[0], 3 - tail.shape[1],
                                          tail.shape[2])), tail], dim=1)
    return tail


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

    @property
    def n_stacked(self) -> int:
        """Layers in JAX's stacked pattern groups (the rest are its
        tail)."""
        period = len(self.cfg.block_pattern)
        return self.cfg.n_layers // period * period

    # --- init ---------------------------------------------------------------
    def init(self, gen: torch.Generator, *, cast: bool = False) -> Params:
        """Float32 master weights drawn from ``gen`` on ``gen.device``, with
        the JAX package's distributions: embeddings N(0, 0.02²), dense
        N(0, 1/d_in), attention ``wo`` N(0, 1/q_dim), norm and qk-norm
        scales 0 (LayerNorm: scale 1, bias 0), the mLSTM gate bias
        [0…, 3…], the sLSTM ``r_mat`` N(0, 1/hd) and ``b_zifo`` 0, the
        conv4 weights N(0, 0.01), the RG-LRU ``lam`` 0.7.

        With ``cast=True`` each tensor is cast as its layer is drawn (an
        MoE layer's expert tensors as each is drawn): the result is
        ``cast_params(init(gen))`` exactly, the same draws, while only one
        layer's float32 masters exist at a time (one expert tensor's, for
        MoE)."""
        cfg = self.cfg
        dt = self.dtype

        def done(tree, min_dim):
            return _cast(tree, dt, min_dim) if cast else tree

        v, d = cfg.padded_vocab, cfg.d_model
        params: Params = {
            "embed": done(torch.randn((v, d), generator=gen,
                                      device=gen.device).mul_(0.02), 2),
            "final_norm": norm_init(cfg, d, gen.device),
        }
        if not cfg.tie_embeddings:
            params["unembed"] = done(torch.randn(
                (v, d), generator=gen, device=gen.device).mul_(0.02), 2)
        params["layers"] = [
            done(_layer_params(cfg, kind, gen, dt if cast else torch.float32),
                 1 if i < self.n_stacked else 2)
            for i, kind in enumerate(self.kinds)]
        if cfg.is_encoder_decoder:
            params["enc_layers"] = [
                done(_layer_params(cfg, "attn", gen), 1)
                for _ in range(cfg.n_encoder_layers)]
            params["enc_norm"] = norm_init(cfg, d, gen.device)
            params["cross_layers"] = [
                done({"attn": _attn_params(cfg, gen),
                      "norm": norm_init(cfg, d, gen.device)}, 1)
                for _ in range(cfg.n_layers)]
        return params

    def cast_params(self, params: Params) -> Params:
        """The parameters ``prefill`` and ``decode_step`` take: the leaves
        JAX casts in the config's compute dtype (identity for float32)."""
        return cast_params(params, self.dtype, self.n_stacked)

    def jax_stacks(self, params: Params) -> List[Tuple[List[int], bool]]:
        """The leaves JAX holds as one stacked leaf, for the optimizer's
        rules that read JAX's layout (``train/optim.py``): groups of leaf
        indices, in the order of ``train.optim.leaves`` (dict keys sorted,
        lists in order), each with its stacked flag.  A pattern group's
        layers at one pattern position and one path form a stack, as do
        the encoder's and the cross layers' at one path; the tail's
        leaves and the top level's stand alone, unstacked."""
        period = len(self.cfg.block_pattern)

        def keyed(tree, key):
            if isinstance(tree, dict):
                return [x for k in sorted(tree)
                        for x in keyed(tree[k], f"{key}/{k}")]
            return [key]

        keys = []
        for name in sorted(params):
            sub = params[name]
            if name == "layers":
                for i, p in enumerate(sub):
                    keys += keyed(p, f"stack:{i % period}" if
                                  i < self.n_stacked else f"tail:{i}")
            elif name in STACKED_LISTS:
                for p in sub:
                    keys += keyed(p, f"stack:{name}")
            else:
                keys += keyed(sub, name)
        groups: Dict[str, List[int]] = {}
        for i, key in enumerate(keys):
            groups.setdefault(key, []).append(i)
        return [(idx, key.startswith("stack:"))
                for key, idx in groups.items()]

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
        return self._scale_embeds(params["embed"][tokens.long()])

    def _scale_embeds(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
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
                    positions: Optional[torch.Tensor], attend, cross=None,
                    decode: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
        """Self-attention through ``attend(q, k, v)``, then ``cross(x)``
        when given (the decoder's cross-attention: whisper's order), then
        the FFN (``decode``: a decode step's).  Returns (x, k, v, the
        FFN's aux loss or None)."""
        cfg = self.cfg
        b, s, _ = x.shape
        h = norm_apply(cfg, x, p["norm1"])
        q, k, v = _attn_qkv(cfg, p["attn"], h, positions)
        o = attend(q, k, v)
        x = x + o.reshape(b, s, cfg.q_dim) @ p["attn"]["wo"]
        if cross is not None:
            x = cross(x)
        h2 = norm_apply(cfg, x, p["norm2"])
        y, aux = self._ffn(p, h2, decode)
        return x + y, k, v, aux

    def _ffn(self, p: Params, h: torch.Tensor, decode: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """An attention layer's FFN and its aux loss (JAX's ``_ffn``): the
        MLP (no aux loss: None), or for MoE ``moe_dispatch`` (prefill and
        training) or ``moe_decode`` (a decode step, None) plus the shared
        experts' MLP.  Only ``loss`` adds the aux loss in, as in JAX."""
        cfg = self.cfg
        aux = None
        if not cfg.is_moe:
            return mlp_apply(cfg, p["mlp"], h), aux
        if decode:
            y = moe.moe_decode(cfg, p["moe"], h)
        else:
            y, aux = moe.moe_dispatch(cfg, p["moe"], h)
        if cfg.n_shared_experts:
            y = y + mlp_apply(cfg, p["shared_mlp"], h)
        return y, aux

    def _rec_inputs(self, p: Params, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The GELU gate and the recurrent branch's input of a ``"rec"``
        block, both in x's dtype."""
        h = norm_apply(self.cfg, x, p["norm1"])
        return act_fn("gelu")(h @ p["proj_gate"]), h @ p["proj_in"]

    def _rec_out(self, p: Params, x: torch.Tensor, gate: torch.Tensor,
                 hr: torch.Tensor) -> torch.Tensor:
        x = x + (gate * hr) @ p["wo"]
        h2 = norm_apply(self.cfg, x, p["norm2"])
        return x + mlp_apply(self.cfg, p["mlp"], h2)

    def _mlstm_inputs(self, p: Params, x: torch.Tensor):
        """q, k, v (B, S, H, hd) and the raw i/f gates (B, S, H) of an
        mLSTM block, from x (B, S, d)."""
        h = norm_apply(self.cfg, x, p["norm1"])
        return _mlstm_heads(self.cfg, p, *(h @ p[w] for w in
                                           ("wq", "wk", "wv", "w_if")))

    def _slstm_inputs(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        """The sLSTM pre-activations (B, S, 4, H, hd), in x's dtype."""
        h = norm_apply(self.cfg, x, p["norm1"])
        return _slstm_heads(self.cfg, p, h @ p["w_zifo"])

    # --- encoder–decoder ----------------------------------------------------
    def _run_encoder(self, params: Params, frames: torch.Tensor
                     ) -> torch.Tensor:
        """Whisper's encoder: sinusoidal positions added to the stub frame
        embeddings (B, F, d), then bidirectional attention layers (no
        RoPE) through the flash kernel, then ``enc_norm``."""
        cfg = self.cfg
        x = frames + sinusoidal_positions(
            frames.shape[1], cfg.d_model, frames.device).to(frames.dtype)
        for p in params["enc_layers"]:
            x = self._attn_layer(
                p, x, None, lambda q, k, v: attn.flash_attention_local(
                    q, k, v, causal=False))[0]
        return norm_apply(cfg, x, params["enc_norm"])

    def _enc_kv(self, pc: Params, enc: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One decoder layer's cross K/V (B, F, KVH, hd) from the encoder's
        output (no bias, as JAX's ``_enc_kv``)."""
        cfg = self.cfg
        b, f, _ = enc.shape
        return tuple((enc @ pc["attn"][w]).reshape(b, f, cfg.n_kv_heads,
                                                   cfg.hd)
                     for w in ("wk", "wv"))

    def _cross_layer(self, pc: Params, x: torch.Tensor, ck: torch.Tensor,
                     cv: torch.Tensor, attend=attn.cross_attention
                     ) -> torch.Tensor:
        """Decoder cross-attention over the encoder's K/V (``model.py:495``):
        in prefill through ``attention.cross_attention``, for the one token
        of a decode step through ``attention.cross_decode_attention`` (JAX's
        ``cross_step``, ``model.py:751``, which normalises before the cast
        to the model dtype), and in training through
        ``ring_attention(causal=False)``, as ``loss`` passes it."""
        cfg = self.cfg
        b, s, _ = x.shape
        h = norm_apply(cfg, x, pc["norm"])
        q = (h @ pc["attn"]["wq"]).reshape(b, s, cfg.n_heads, cfg.hd)
        o = attend(q, ck, cv)
        return x + o.reshape(b, s, cfg.q_dim) @ pc["attn"]["wo"]

    # --- training ------------------------------------------------------------
    def _layer_train(self, kind: str, p: Params, x: torch.Tensor,
                     positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One layer in training form (JAX's ``_layer_seq``,
        ``model.py:194-256``): (x, its aux loss or None)."""
        cfg = self.cfg
        b, s, d = x.shape
        if kind in ("attn", "local"):
            window = cfg.window if kind == "local" else 0
            x, _, _, aux = self._attn_layer(
                p, x, positions, lambda q, k, v: attn.ring_attention(
                    q, k, v, causal=True, window=window))
            return x, aux
        if kind == "rec":
            gate, xin = self._rec_inputs(p, x)
            hr = rec.rglru_seq(xin, p["w_rg"], p["b_rg"], p["w_ig"],
                               p["b_ig"], p["conv_w"], p["conv_b"],
                               p["lam"])
            x = self._rec_out(p, x, gate, hr)
        elif kind == "m":
            o = rec.mlstm_seq(*self._mlstm_inputs(p, x))
            x = x + o.reshape(b, s, d) @ p["wo"]
        else:
            o = rec.slstm_train(self._slstm_inputs(p, x), p["r_mat"])
            x = x + o.reshape(b, s, d) @ p["wo"]
        return x, None

    def _run_stack(self, params: Params, x: torch.Tensor,
                   positions: torch.Tensor, *, remat: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The layers in training form (JAX's ``_run_stack``,
        ``model.py:450``): each pattern group of ``len(block_pattern)``
        layers under ``torch.utils.checkpoint`` when ``remat`` (JAX's
        ``jax.checkpoint(group)``: only the group's input is kept, its
        activations are recomputed in the backward), the unrolled tail
        never.  Returns (x, the summed aux loss)."""
        period = len(self.cfg.block_pattern)
        layers = list(zip(self.kinds, params["layers"]))

        def group(x, chunk):
            auxs = []
            for kind, p in chunk:
                x, a = self._layer_train(kind, p, x, positions)
                auxs.append(a)
            return x, auxs

        aux_total = x.new_zeros((), dtype=torch.float32)
        for g0 in range(0, self.n_stacked, period):
            chunk = layers[g0:g0 + period]
            x, auxs = (checkpoint(group, x, chunk, use_reentrant=False)
                       if remat else group(x, chunk))
            for a in auxs:
                if a is not None:
                    aux_total = aux_total + a
        for kind, p in layers[self.n_stacked:]:
            x, a = self._layer_train(kind, p, x, positions)
            if a is not None:
                aux_total = aux_total + a
        return x, aux_total

    def _train_encoder(self, params: Params, frames: torch.Tensor
                       ) -> torch.Tensor:
        """The encoder in training form (JAX's ``_run_encoder``,
        ``model.py:480``): bidirectional ``ring_attention``, each layer
        under ``torch.utils.checkpoint`` whatever ``remat`` says."""
        cfg = self.cfg
        x = frames + sinusoidal_positions(
            frames.shape[1], cfg.d_model, frames.device).to(frames.dtype)

        def layer(x, p):
            return self._attn_layer(
                p, x, None, lambda q, k, v: attn.ring_attention(
                    q, k, v, causal=False))[0]

        for p in params["enc_layers"]:
            x = checkpoint(layer, x, p, use_reentrant=False)
        return norm_apply(cfg, x, params["enc_norm"])

    def _train_decoder(self, params: Params, x: torch.Tensor,
                       enc: torch.Tensor, positions: torch.Tensor
                       ) -> torch.Tensor:
        """The decoder in training form (JAX's ``_run_decoder_with_cross``
        without caches, ``model.py:520``): causal self-attention, cross
        attention over the encoder's K/V (bidirectional
        ``ring_attention``, as JAX's ``cross_attention``), the FFN; each
        layer under ``torch.utils.checkpoint``."""
        def cross_attend(q, k, v):
            return attn.ring_attention(q, k, v, causal=False)

        def layer(x, p, pc, enc):
            ck, cv = self._enc_kv(pc, enc)
            return self._attn_layer(
                p, x, positions,
                lambda q, k, v: attn.ring_attention(q, k, v, causal=True),
                lambda x: self._cross_layer(pc, x, ck, cv, cross_attend))[0]

        for p, pc in zip(params["layers"], params["cross_layers"]):
            x = checkpoint(layer, x, p, pc, enc, use_reentrant=False)
        return x

    def loss(self, params: Params, batch: Dict[str, torch.Tensor], *,
             remat: bool = True, env: Optional[MeshEnv] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Teacher-forced LM loss (JAX's ``Model.loss``, ``model.py:555``):
        the parameters cast as ``cast_params`` casts them (float32 masters
        or copies already cast: the cast is idempotent, and its gradient
        reaches float32 masters in float32); ``batch["tokens"]`` embedded,
        the VLM's ``patch_embeds`` spliced over the first positions, the
        encoder–decoder's ``frames`` through the encoder; the layers in
        training form (``_run_stack``, remat per pattern group when
        ``remat``); the logits in float32; the NLL of ``labels`` at the
        positions where ``labels >= 0``, through a float32 logsumexp,
        averaged.  Returns (nll + 0.01 · aux, {"nll", "aux"}), 0-d
        float32 tensors; differentiable, and no kernel of the port
        runs.  The head runs over ``HEAD_CHUNK`` tokens at a time, each
        chunk recomputed in the backward: JAX holds every float32 logit
        at once (1.25e9 of them, 5 GB, at qwen3-1.7b's vocabulary and
        2 × 4,096 tokens, and its softmax and gradient beside them); the
        per-token math is the same, and the chunks' sums are added in
        chunk order.  With ``env``: the grid (``_grid_loss``)."""
        cfg = self.cfg
        params = self.cast_params(params)
        if env is not None:
            return self._grid_loss(params, batch, env, remat)
        tokens, labels = batch["tokens"], batch["labels"]
        x = self._embed(params, tokens)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            pe = batch["patch_embeds"].to(x.dtype)
            x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)
        if cfg.is_encoder_decoder:
            enc = self._train_encoder(params, batch["frames"].to(x.dtype))
            x = self._train_decoder(params, x, enc, positions)
            aux = x.new_zeros((), dtype=torch.float32)
        else:
            x, aux = self._run_stack(params, x, positions, remat=remat)
        x = norm_apply(cfg, x, params["final_norm"])
        xs = x.reshape(-1, x.shape[-1])
        ls = labels.reshape(-1)
        nll = sum(checkpoint(self._nll_sum, params, xs[i:i + HEAD_CHUNK],
                             ls[i:i + HEAD_CHUNK], use_reentrant=False)
                  for i in range(0, xs.shape[0], HEAD_CHUNK))
        loss = nll / torch.clamp((labels >= 0).sum().float(), min=1.0)
        return loss + 0.01 * aux, {"nll": loss, "aux": aux}

    def _nll_sum(self, params: Params, x: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
        """Σ of the NLL of ``labels`` (T,) over the rows of x (T, d) where
        ``labels >= 0``: float32 logits, a float32 logsumexp minus the
        label's logit (JAX's ``loss``, ``model.py:575-583``)."""
        logits = self._logits(params, x).float()
        mask = (labels >= 0).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.clamp(min=0).long()[:, None])[:, 0]
        return ((lse - gold) * mask).sum()

    # --- prefill -------------------------------------------------------------
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                cache_len: Optional[int] = None, *,
                env: Optional[MeshEnv] = None
                ) -> Tuple[torch.Tensor, Cache]:
        """Forward over the prompt ``batch["tokens"]`` (B, S) — with
        ``batch["patch_embeds"]`` (B, P, d) over the first P positions for
        the VLM, and the encoder over ``batch["frames"]`` (B, F, d) for the
        encoder–decoder; returns (last-position logits (B, 1,
        padded_vocab) float32, caches): one dict per layer, {"k", "v"}
        (B, cache_len, KVH, hd) holding the prompt's K/V (default
        cache_len: S) for ``"attn"`` (and the encoder's cross K/V for the
        encoder–decoder), the rolling window for ``"local"``, the final
        recurrent state for ``"rec"``, ``"m"`` and ``"s"``.  With ``env``:
        the grid (``_grid_forward``); the caches are ``Sharded`` pieces by
        ``cache_specs``."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache_len = cache_len or s
        if env is not None:
            return self._grid_prefill(params, batch, cache_len, env)
        x = self._embed(params, tokens)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            pe = batch["patch_embeds"].to(x.dtype)
            x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
        d = x.shape[-1]
        positions = torch.arange(s, device=x.device)
        caches: Cache = []
        enc = None
        if cfg.is_encoder_decoder:
            enc = self._run_encoder(params, batch["frames"].to(x.dtype))
        for i, (kind, p) in enumerate(zip(self.kinds, params["layers"])):
            if kind in ("attn", "local"):
                window = cfg.window if kind == "local" else 0
                cross, cache = None, {}
                if enc is not None:
                    pc = params["cross_layers"][i]
                    ck, cv = self._enc_kv(pc, enc)
                    cache = {"cross_k": ck, "cross_v": cv}
                    cross = (lambda x, pc=pc, ck=ck, cv=cv:
                             self._cross_layer(pc, x, ck, cv))
                x, k, v, _ = self._attn_layer(
                    p, x, positions,
                    lambda q, k, v: attn.flash_attention_local(
                        q, k, v, causal=True, window=window), cross)
                if kind == "local":
                    cache.update(_window_cache(k, v, cfg.window, cache_len))
                else:
                    cache.update(k=_pad_cache(k, cache_len),
                                 v=_pad_cache(v, cache_len))
                caches.append(cache)
            elif kind == "rec":
                gate, xin = self._rec_inputs(p, x)
                hr = rec.rglru_seq(xin, p["w_rg"], p["b_rg"], p["w_ig"],
                                   p["b_ig"], p["conv_w"], p["conv_b"],
                                   p["lam"])
                x = self._rec_out(p, x, gate, hr)
                caches.append({"h": hr[:, -1].to(torch.float32, copy=True),
                               "tail": _conv_tail(xin)})
            elif kind == "m":
                o, (c, n) = rec.mlstm_with_state(*self._mlstm_inputs(p, x))
                x = x + o.reshape(b, s, d) @ p["wo"]
                caches.append({"c": c, "n": n})
            else:
                o, st = rec.slstm_with_state(self._slstm_inputs(p, x),
                                             p["r_mat"])
                x = x + o.reshape(b, s, d) @ p["wo"]
                caches.append(dict(zip(("c", "n", "h", "m"), st)))
        x = norm_apply(cfg, x, params["final_norm"])
        return self._logits(params, x[:, -1:]).float(), caches

    # --- decode --------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int,
                   device: Union[str, torch.device, None] = None, *,
                   env: Optional[MeshEnv] = None) -> Cache:
        """Empty caches, one dict per layer, as JAX's ``_layer_cache``
        (``model.py:263``) and ``init_cache`` (``model.py:712``): zero K/V
        (``"local"``: a ring of min(window, cache_len) slots, all empty),
        zero (c, n) and, for ``"s"``, zero h and m = -1e30; zero h and
        tail for ``"rec"``; zero cross K/V of ``encoder_frames`` frames
        for the encoder–decoder.  With ``env``: made on the first cell and
        cut by ``cache_specs`` into ``Sharded`` pieces."""
        cfg = self.cfg
        if env is not None:
            return self.shard_caches(
                self.init_cache(batch, cache_len, env.first), env, batch)
        hn, hdm, d = cfg.n_heads, cfg.d_model // cfg.n_heads, cfg.d_model
        caches: Cache = []
        for kind in self.kinds:
            if kind in ("attn", "local"):
                n = min(cfg.window, cache_len) if kind == "local" \
                    else cache_len
                shape = (batch, n, cfg.n_kv_heads, cfg.hd)
                c = {"k": torch.zeros(shape, dtype=self.dtype, device=device),
                     "v": torch.zeros(shape, dtype=self.dtype, device=device)}
                if kind == "local":
                    c["kpos"] = torch.full((n,), -1, dtype=torch.int32,
                                           device=device)
                if cfg.is_encoder_decoder:
                    shape = (batch, encoder_frames(cfg), cfg.n_kv_heads,
                             cfg.hd)
                    c["cross_k"] = torch.zeros(shape, dtype=self.dtype,
                                               device=device)
                    c["cross_v"] = torch.zeros_like(c["cross_k"])
                caches.append(c)
                continue
            if kind == "rec":
                caches.append({"h": torch.zeros((batch, d), device=device),
                               "tail": torch.zeros((batch, 3, d),
                                                   device=device)})
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
                    pos: Union[int, torch.Tensor], *,
                    env: Optional[MeshEnv] = None
                    ) -> Tuple[torch.Tensor, Cache]:
        """token: (B, 1) int; pos: the new token's position, an int or a
        0-d int32 tensor on the device (read there: no host round trip;
        the recurrent layers ignore it).  Writes the token's K/V into the
        attention caches in place and the new recurrent states into their
        caches' dicts; returns (logits (B, 1, padded_vocab) float32,
        caches).  With ``env``: the grid (``_grid_decode``), caches as
        ``init_cache(env=...)`` or ``prefill(env=...)`` give them; pass the
        parameters cut once into their pieces (``sharding.pieces``, as
        ``launch.serve.generate`` does): whole tensors are cut again on
        every step, which copies each piece to its device."""
        cfg = self.cfg
        if env is not None:
            return self._grid_decode(params, caches, token, pos, env)
        x = self._embed(params, token)
        b, _, d = x.shape
        pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
        positions = pos.reshape(1)
        for i, (kind, p, c) in enumerate(zip(self.kinds, params["layers"],
                                             caches)):
            if kind == "attn":
                cross = None
                if cfg.is_encoder_decoder:
                    pc = params["cross_layers"][i]
                    cross = (lambda x, pc=pc, c=c: self._cross_layer(
                        pc, x, c["cross_k"], c["cross_v"],
                        attn.cross_decode_attention))
                x = self._attn_layer(
                    p, x, positions,
                    lambda q, k, v, c=c: attn.decode_attention(
                        q, c["k"], c["v"], k, v, pos)[0], cross,
                    decode=True)[0]
            elif kind == "local":
                x = self._attn_layer(
                    p, x, positions,
                    lambda q, k, v, c=c: attn.window_decode_attention(
                        q, c["k"], c["v"], c["kpos"], k, v, pos,
                        window=cfg.window)[0], decode=True)[0]
            elif kind == "rec":
                gate, xin = self._rec_inputs(p, x[:, 0])
                (c["h"], c["tail"]), hr = rec.rglru_decode_step(
                    (c["h"], c["tail"]), xin, p["w_rg"], p["b_rg"],
                    p["w_ig"], p["b_ig"], p["conv_w"], p["conv_b"],
                    p["lam"])
                x = self._rec_out(p, x, gate[:, None], hr[:, None])
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
        x = norm_apply(cfg, x, params["final_norm"])
        return self._logits(params, x).float(), caches


    # --- the grid -------------------------------------------------------------
    # One tensor per cell (``sh.cellwise`` runs a step once per distinct
    # argument tuple: work JAX replicates runs once per device).

    def shard_caches(self, caches: Cache, env: MeshEnv, batch: int) -> Cache:
        """Whole caches cut into ``Sharded`` pieces by ``cache_specs``, each
        piece a tensor of its own: a piece that stayed a view would keep
        the whole cache alive on the first cell's device."""
        specs = sh.cache_specs(caches, env, batch)
        return [{k: sh.own_pieces(sh.shard(t, specs[i][k], env))
                 for k, t in c.items()} for i, c in enumerate(caches)]

    @staticmethod
    def gather_caches(caches: Cache, env: MeshEnv) -> Cache:
        """Grid caches joined whole on the first cell's device."""
        return [{k: sh.unshard(t, None, env) for k, t in c.items()}
                for c in caches]

    def _grid_norm(self, p: Params, xs: sh.Cells, env: MeshEnv
                   ) -> sh.Cells:
        """A top-level norm (``final_norm``, ``enc_norm``) on every cell."""
        trees = sh.cell_trees(sh.gather_for_compute(p, env), env.n_cells)
        return sh.cellwise(lambda q, x: norm_apply(self.cfg, x, q), trees,
                           xs)

    def _grid_layer(self, p: Params, env: MeshEnv):
        """A layer's weights through ``gather_for_compute``: (the tree of
        cell lists, one tree per cell)."""
        lp = sh.gather_for_compute(p, env)
        return lp, sh.cell_trees(lp, env.n_cells)

    def _grid_tables(self, params: Params, env: MeshEnv) -> Params:
        """``params`` with the embedding whole on each cell's device (a
        cell list; a device that holds it whole gets it with no copy),
        gathered once for the lookup and for a tied head, as JAX's compiled
        lookup gathers it at the published shapes.  An untied unembedding
        stays in its pieces (``_vocab_slices``)."""
        p = dict(params)
        p["embed"] = (sh.gather_whole(p["embed"], None, env)
                      if isinstance(p["embed"], list)
                      else sh.replicate(p["embed"], env))
        return p

    def _grid_embed(self, params: Params, tokens: torch.Tensor,
                    batch: Dict[str, torch.Tensor], env: MeshEnv
                    ) -> sh.Cells:
        """The embedding of a prompt laid out (dp, sp, None), each cell
        embedding its own tokens, cut from wherever the caller holds them
        (no whole (B, S, d) on the first cell), the VLM's patch
        embeddings spliced over the first positions.  ``params`` as
        ``_grid_tables`` gives them."""
        cfg = self.cfg
        spec = sh.logical_spec((*tokens.shape, cfg.d_model),
                               ("dp", "sp", None), env)
        toks = sh.shard(tokens, spec[:2], env)
        xs = sh.cellwise(lambda w, t: self._embed({"embed": w}, t),
                         params["embed"], toks)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            n, s_loc = batch["patch_embeds"].shape[1], xs[0].shape[1]
            pes = sh.shard(batch["patch_embeds"], P(spec[0], None, None),
                           env)

            def splice(x, pe, m):
                lo = m * s_loc
                k = min(max(n - lo, 0), s_loc)
                if k == 0:
                    return x
                return torch.cat([pe[:, lo:lo + k].to(x.dtype), x[:, k:]],
                                 dim=1)

            xs = sh.cellwise(splice, xs, pes,
                             [env.axis_index(c, spec[1])
                              for c in range(env.n_cells)])
        return sh.Sharded(xs, spec)

    def _positions(self, xs: sh.Cells, env: MeshEnv) -> sh.Cells:
        """Each cell's global positions m·S_loc + arange(S_loc)."""
        s_loc = xs[0].shape[1]
        return sh.cellwise(
            lambda x, m: m * s_loc + torch.arange(s_loc, device=x.device),
            xs, [env.axis_index(c, "model") for c in range(env.n_cells)])

    def _row_last(self, cells: sh.Cells, env: MeshEnv) -> sh.Cells:
        """Each cell's copy of the value on the last ``model`` rank of its
        group (a recurrent layer's final state), once per device."""
        out: List[Any] = [None] * env.n_cells
        for grp in sh._groups(env, ("model",)):
            last = cells[grp[-1]]
            sent = {}
            for c in grp:
                dev = env.cells[c]
                if dev not in sent:
                    sent[dev] = (tuple(t.to(dev) for t in last)
                                 if isinstance(last, tuple) else last.to(dev))
                out[c] = sent[dev]
        return out

    def _grid_ffn(self, lp: Params, trees: List[Params], hs: sh.Cells,
                  env: MeshEnv):
        """``_ffn`` on the grid in sequence form: the MLP per cell, or the
        expert-parallel MoE dispatch (and the shared experts' MLP).
        Returns (y cells, aux or None)."""
        cfg = self.cfg
        aux = None
        if not cfg.is_moe:
            return sh.cellwise(lambda p, h: mlp_apply(cfg, p["mlp"], h),
                               trees, hs), aux
        ys, aux = moe._dispatch_cells(cfg, moe._expert_cells(lp["moe"], env),
                                      hs, env)
        if cfg.n_shared_experts:
            ys = sh.cellwise(
                lambda p, h, y: y + mlp_apply(cfg, p["shared_mlp"], h),
                trees, hs, ys)
        return ys, aux

    def _grid_attn(self, kind: str, lp: Params, trees: List[Params],
                   xs: sh.Cells, pos: Optional[sh.Cells], env: MeshEnv,
                   causal: bool = True, cross=None):
        """An attention layer on the grid in sequence form: the ring over
        ``model`` (the flash kernel a step in serving), ``cross(xs)`` when
        given, the FFN.  Returns (xs, k cells, v cells, aux or None)."""
        cfg = self.cfg
        window = cfg.window if kind == "local" else 0
        hs = sh.cellwise(lambda p, x: norm_apply(cfg, x, p["norm1"]),
                         trees, xs)
        qkv = sh.cellwise(
            lambda p, h, ps: _attn_qkv(cfg, p["attn"], h, ps), trees, hs,
            pos if pos is not None else [None] * env.n_cells)
        q, k, v = sh.unzip(qkv)
        o = attn._ring_cells(q, k, v, env, causal=causal, window=window)
        xs = sh.cellwise(
            lambda p, x, o: x + o.reshape(x.shape[0], x.shape[1],
                                          cfg.q_dim) @ p["attn"]["wo"],
            trees, xs, o)
        if cross is not None:
            xs = cross(xs)
        h2 = sh.cellwise(lambda p, x: norm_apply(cfg, x, p["norm2"]),
                         trees, xs)
        ys, aux = self._grid_ffn(lp, trees, h2, env)
        return sh.cellwise(torch.add, xs, ys), k, v, aux

    def _grid_cross(self, lpc: Params, tpc: List[Params], xs: sh.Cells,
                    ck: sh.Cells, cv: sh.Cells, env: MeshEnv) -> sh.Cells:
        """Decoder cross attention on the grid: the bidirectional ring over
        the encoder's sequence-sharded K/V."""
        cfg = self.cfg
        hs = sh.cellwise(lambda p, x: norm_apply(cfg, x, p["norm"]), tpc, xs)
        qs = sh.cellwise(
            lambda p, h: (h @ p["attn"]["wq"]).reshape(
                h.shape[0], h.shape[1], cfg.n_heads, cfg.hd), tpc, hs)
        o = attn._ring_cells(qs, ck, cv, env, causal=False, window=0)
        return sh.cellwise(
            lambda p, x, o: x + o.reshape(x.shape[0], x.shape[1],
                                          cfg.q_dim) @ p["attn"]["wo"],
            tpc, xs, o)

    def _grid_recurrent(self, kind: str, lp: Params, trees: List[Params],
                        xs: sh.Cells, env: MeshEnv, train: bool):
        """A ``"rec"``, ``"m"`` or ``"s"`` layer on the grid in sequence
        form.  Returns (xs, each cell's cache dict of final states)."""
        if kind == "rec":
            gx = sh.cellwise(lambda p, x: self._rec_inputs(p, x), trees, xs)
            gate, xin = sh.unzip(gx)
            ws = [lp[k] for k in ("w_rg", "b_rg", "w_ig", "b_ig", "conv_w",
                                  "conv_b", "lam")]
            hr = rec._rglru_cells(xin, ws, env)
            xs = sh.cellwise(lambda p, x, g, h: self._rec_out(p, x, g, h),
                             trees, xs, gate, hr)
            if xin[0].shape[1] >= 3:
                tail = sh.cellwise(_conv_tail, xin)
            else:
                tail = sh.cellwise(_conv_tail,
                                   sh.all_gather(xin, env, "model", 1))
            h_last = sh.cellwise(
                lambda h: h[:, -1].to(torch.float32, copy=True), hr)
            return xs, {"h": self._row_last(h_last, env),
                        "tail": self._row_last(tail, env)}
        if kind == "m":
            ins = sh.cellwise(lambda p, x: self._mlstm_inputs(p, x), trees,
                              xs)
            o, finals = rec._mlstm_cells(*sh.unzip(ins), env,
                                         rec.MLSTM_CHUNK)
            xs = sh.cellwise(
                lambda p, x, o: x + o.reshape(x.shape) @ p["wo"], trees, xs,
                o)
            fin = self._row_last(finals, env)
            return xs, {"c": [f[1] for f in fin], "n": [f[2] for f in fin]}
        pre = sh.cellwise(lambda p, x: self._slstm_inputs(p, x), trees, xs)
        rs = lp["r_mat"]
        if train:
            o, finals = rec._slstm_train_cells(pre, rs, env)
        else:
            o, finals = rec._slstm_chain(
                pre, env, lambda x, st, c: slstm_ops.slstm_scan(x, rs[c],
                                                                *st))
        xs = sh.cellwise(lambda p, x, o: x + o.reshape(x.shape) @ p["wo"],
                         trees, xs, o)
        fin = self._row_last(finals, env)
        return xs, {k: [f[i] for f in fin] for i, k in
                    enumerate(("c", "n", "h", "m"))}

    def _grid_encoder(self, params: Params, frames: torch.Tensor,
                      env: MeshEnv, remat: bool, dtype: torch.dtype
                      ) -> sh.Cells:
        """Whisper's encoder on the grid: the frames (cut from wherever the
        caller holds them, each piece cast to ``dtype`` and given its
        sinusoidal positions) laid out (dp, sp, None), bidirectional ring
        attention layers, ``enc_norm``."""
        cfg = self.cfg
        f = frames.shape[1]
        spec = sh.logical_spec(frames.shape, ("dp", "sp", None), env)
        fs = sh.shard(frames, spec, env)
        s_loc = fs[0].shape[1]
        xs = sh.cellwise(
            lambda x, m: x.to(dtype) + sinusoidal_positions(
                f, cfg.d_model, x.device)[m * s_loc:(m + 1) * s_loc].to(dtype),
            fs, [env.axis_index(c, spec[1]) for c in range(env.n_cells)])

        def layer(xs, p):
            lp, trees = self._grid_layer(p, env)
            return self._grid_attn("attn", lp, trees, xs, None, env,
                                   causal=False)[0]

        for p in params["enc_layers"]:
            xs = (checkpoint(layer, xs, p, use_reentrant=False) if remat
                  else layer(xs, p))
        return self._grid_norm(params["enc_norm"], xs, env)

    def _grid_stack(self, params: Params, xs: sh.Cells, env: MeshEnv,
                    cache_len: Optional[int], train: bool, remat: bool,
                    batch: int, enc: Optional[sh.Cells] = None):
        """Every layer on the grid in sequence form.  Returns (xs, the
        summed aux loss, each layer's caches as cell lists when
        ``cache_len``)."""
        cfg = self.cfg
        pos = self._positions(xs, env)
        caches: List[Dict[str, Any]] = []

        def one(i, kind, p, xs):
            lp, trees = self._grid_layer(p, env)
            if kind in ("attn", "local"):
                cross = None
                cache: Dict[str, Any] = {}
                if enc is not None:
                    pc = params["cross_layers"][i]
                    lpc, tpc = self._grid_layer(pc, env)
                    ckv = sh.cellwise(lambda p, e: self._enc_kv(p, e), tpc,
                                      enc)
                    ck, cv = sh.unzip(ckv)
                    cross = (lambda xs: self._grid_cross(lpc, tpc, xs, ck, cv,
                                                         env))
                    if cache_len:
                        cache = {"cross_k": sh.all_gather(ck, env, "model",
                                                          1),
                                 "cross_v": sh.all_gather(cv, env, "model",
                                                          1)}
                xs, k, v, aux = self._grid_attn(kind, lp, trees, xs, pos,
                                                env, cross=cross)
                if cache_len:
                    cache.update(self._grid_kv_cache(kind, k, v, env,
                                                     cache_len, batch))
                return xs, aux, cache
            xs, cache = self._grid_recurrent(kind, lp, trees, xs, env, train)
            return xs, None, cache

        # training keeps each pattern group's input only and recomputes
        # the group in the backward (the encoder–decoder: each layer), as
        # the one-device ``_run_stack`` and ``_train_decoder`` do
        period = 1 if enc is not None else len(cfg.block_pattern)
        layers = list(enumerate(zip(self.kinds, params["layers"])))
        aux_total = None

        def group(xs, chunk):
            auxs, cs = [], []
            for i, (kind, p) in chunk:
                xs, a, c = one(i, kind, p, xs)
                auxs.append(a)
                cs.append(c)
            return xs, auxs, cs

        i0 = 0
        while i0 < len(layers):
            n = period if i0 < self.n_stacked else 1
            chunk = layers[i0:i0 + n]
            if train and (remat or enc is not None) and (
                    i0 < self.n_stacked or enc is not None):
                xs, auxs, cs = checkpoint(group, xs, chunk,
                                          use_reentrant=False)
            else:
                xs, auxs, cs = group(xs, chunk)
            for a in auxs:
                if a is not None:
                    aux_total = a if aux_total is None else aux_total + a
            caches += cs
            i0 += n
        return xs, aux_total, caches

    def _grid_kv_cache(self, kind: str, k: sh.Cells, v: sh.Cells,
                       env: MeshEnv, cache_len: int, b: int
                       ) -> Dict[str, Any]:
        """A prompt's K/V cells (batch ``b`` in all) as the layer's decode
        cache: joined whole, padded to ``cache_len`` (``"attn"``) or kept
        as the rolling window (``"local"``), cut by ``cache_specs``."""
        spec = sh.seq_spec(env, b, 4)
        kw, vw = sh.unshard(k, spec, env), sh.unshard(v, spec, env)
        if kind == "local":
            whole = _window_cache(kw, vw, self.cfg.window, cache_len)
        else:
            whole = {"k": _pad_cache(kw, cache_len),
                     "v": _pad_cache(vw, cache_len)}
        return self.shard_caches([whole], env, kw.shape[0])[0]

    def _grid_head(self, params: Params, xs: sh.Cells, env: MeshEnv,
                   batch_split: bool, slices=None) -> torch.Tensor:
        """``final_norm`` and ``_logits`` on the grid (``model.py:434-447``):
        each cell's rows (B_loc, 1, d) against its vocabulary slice (the
        vocabulary over ``model`` when it divides, else whole), joined as
        (dp, None, tp) into float32 logits (B, 1, V) on the first cell.
        ``slices``: (cells, vocab axis) as ``_head_slices`` gives them;
        by default ``_vocab_slices``."""
        hs = self._grid_norm(params["final_norm"], xs, env)
        w_slices, spec = slices or self._vocab_slices(params, env)
        logits = sh.cellwise(lambda h, w: (h @ w.t()).float(), hs, w_slices)
        dp = env.dp_axes if batch_split else None
        return sh.unshard(logits, P(dp, None, spec), env)

    def _vocab_slices(self, params: Params, env: MeshEnv):
        """Each cell's rows of the unembedding for the prefill and the
        loss.  Tied: its ``model`` rank's slice of the vocabulary (a view
        of the table ``_grid_tables`` gathered whole on its device for the
        lookup), or the whole when V does not divide.  Untied: the table's
        own pieces as ``_head_slices`` lays them out (JAX's ``_logits``), so
        no cell receives the other ranks' vocabulary and, in the loss, the
        gradient reaches each piece through the feature dim's all-gather
        alone.  Returns (cells, the vocab dim's axis or None).  A decode
        step takes ``_head_slices`` for both."""
        if not self.cfg.tie_embeddings:
            return self._head_slices(params, env)
        whole = params["embed"]              # as _grid_tables gives them
        n = env.tp_size
        v = whole[0].shape[0]
        if n == 1 or v % n:
            return whole, None
        step = v // n
        return sh.cellwise(lambda t, m: t[m * step:(m + 1) * step], whole,
                           [env.axis_index(c, "model")
                            for c in range(env.n_cells)]), env.tp_axis

    def _head_slices(self, params: Params, env: MeshEnv):
        """A decode step's unembedding as JAX's ``_logits`` lays it out
        (``model.py:434-447``): the table's pieces with the vocabulary kept
        over ``model`` and the feature dim all-gathered over its axes
        (``data`` in the train profile; in the serve profile nothing
        moves).  Returns (cells, the vocab dim's axis or None)."""
        key = "embed" if self.cfg.tie_embeddings else "unembed"
        w = sh.pieces({key: params[key]}, env)[key]
        v_axes, d_axes = w.spec
        cells = sh.all_gather(w, env, d_axes, 1) if env.size(d_axes) > 1 \
            else w
        return cells, (v_axes if env.size(v_axes) > 1 else None)

    def _grid_prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                      cache_len: int, env: MeshEnv):
        cfg = self.cfg
        _refuse_ragged(env, batch)
        params = self._grid_tables(params, env)
        xs = self._grid_embed(params, batch["tokens"], batch, env)
        enc = None
        if cfg.is_encoder_decoder:
            enc = self._grid_encoder(params, batch["frames"], env,
                                     remat=False, dtype=xs[0].dtype)
        b = batch["tokens"].shape[0]
        xs, _, cells = self._grid_stack(params, xs, env, cache_len,
                                        train=False, remat=False, batch=b,
                                        enc=enc)
        split = bool(env.dp_axes) and b % env.dp_size == 0
        state_spec = P(env.dp_axes if split else None)
        caches = [{name: t if isinstance(t, sh.Sharded)   # states, cross K/V:
                   else sh.Sharded(t, state_spec)         # batch over DP
                   for name, t in c.items()} for c in cells]
        # the last position lives on each row's last "model" rank
        last = self._row_last(sh.cellwise(lambda x: x[:, -1:], xs), env)
        return self._grid_head(params, last, env, split), caches

    def _grid_loss(self, params: Params, batch: Dict[str, torch.Tensor],
                   env: MeshEnv, remat: bool):
        """``loss`` on the grid: the stack in training form over (dp, sp)
        cells, then the vocabulary-parallel NLL (``_grid_nll``), summed
        over the cells in rank order."""
        cfg = self.cfg
        _refuse_ragged(env, batch)
        params = self._grid_tables(params, env)
        xs = self._grid_embed(params, batch["tokens"], batch, env)
        enc = None
        if cfg.is_encoder_decoder:
            enc = self._grid_encoder(params, batch["frames"], env,
                                     remat=True, dtype=xs[0].dtype)
        xs, aux, _ = self._grid_stack(params, xs, env, None, train=True,
                                      remat=remat,
                                      batch=batch["tokens"].shape[0],
                                      enc=enc)
        if aux is None or cfg.is_encoder_decoder:
            aux = torch.zeros((), dtype=torch.float32, device=env.first)
        labels = batch["labels"]     # cut from where the caller holds it
        ls = sh.constrain(labels, "dp", "sp", env=env)
        nll = self._grid_nll(params, xs, ls, env)
        loss = nll / torch.clamp((labels >= 0).sum().float().to(env.first),
                                 min=1.0)
        return loss + 0.01 * aux, {"nll": loss, "aux": aux}

    def _grid_nll(self, params: Params, xs: sh.Cells, ls: sh.Cells,
                  env: MeshEnv) -> torch.Tensor:
        """Σ NLL over every cell's tokens: ``final_norm``, then per data row
        the rows all-gathered over ``model`` (the (dp, None, tp) layout of
        JAX's logits) against each cell's vocabulary slice, ``HEAD_CHUNK``
        tokens at a time (each chunk recomputed in the backward); the
        slices' log-sum-exps and gold logits combined in rank order.
        Without a vocabulary split each cell takes its own tokens whole."""
        hs = self._grid_norm(params["final_norm"], xs, env)
        w_slices, split = self._vocab_slices(params, env)
        if split is None:
            parts = sh.cellwise(
                lambda h, w, l: sum(
                    checkpoint(_nll_chunk_sum, h.reshape(-1, h.shape[-1])[i:
                               i + HEAD_CHUNK], w,
                               l.reshape(-1)[i:i + HEAD_CHUNK],
                               use_reentrant=False)
                    for i in range(0, l.numel(), HEAD_CHUNK)),
                hs, w_slices, ls)
            uniq = list({id(p): p for p in parts}.values())
            return sh.all_reduce([p.to(env.first) for p in uniq])[0]
        rows = sh.all_gather(hs, env, "model", 1)
        lrow = sh.all_gather(ls, env, "model", 1)
        step = w_slices[0].shape[0]
        total = None
        for grp in sh._groups(env, ("model",)):
            d = rows[grp[0]].shape[-1]
            hrows = [rows[c].reshape(-1, d) for c in grp]
            labs = [lrow[c].reshape(-1) for c in grp]
            for i in range(0, labs[0].numel(), HEAD_CHUNK):
                part = checkpoint(
                    _vocab_nll_chunk_sum, step,
                    [h[i:i + HEAD_CHUNK] for h in hrows],
                    [l[i:i + HEAD_CHUNK] for l in labs],
                    *[w_slices[c] for c in grp], use_reentrant=False)
                part = part.to(env.first)
                total = part if total is None else total + part
        return total

    # the weight leaves a grid decode step still all-gathers, by their last
    # name (``_grid_decode``'s docstring): a "rec" layer's conv taps, the
    # MoE router; ``launch/dryrun.py`` reports any other as stray
    DECODE_GATHERED = ("conv_w", "router")

    def _grid_decode(self, params: Params, caches: Cache,
                     token: torch.Tensor, pos, env: MeshEnv):
        """``decode_step`` on the grid, weight-stationary as JAX's
        ``decode_step`` is (``model.py:787-791``: one token cannot amortize
        a per-layer weight gather): each cell multiplies by its own pieces
        of the weights and only activations cross the grid.  The token rows
        lie over ``data``, whole over ``model``.  Every product by a layer
        weight goes through ``sharding.sharded_dot`` (q, k, v and ``wo``;
        the MLP's and the shared experts' gate, up and down; whisper's
        cross ``wq`` and ``wo``; ``proj_gate``, ``proj_in``, the RG-LRU's
        ``w_rg`` and ``w_ig`` (in float32, as one device) and ``wo`` of a
        ``"rec"`` layer; ``wq``, ``wk``, ``wv``, ``w_if``, ``wo`` of an
        ``"m"`` layer; ``w_zifo`` and ``wo`` of an ``"s"`` layer); the
        embedding looks each id up in its vocabulary block
        (``sharding.sharded_take``); the head keeps the vocabulary over
        ``model`` (``_head_slices``).  The split-K decode runs over the
        cache shards and the rolling window's (``_grid_window_decode``),
        the MoE experts run expert-parallel.  The math that reads no weight
        is split by head over ``model`` where n divides H, as XLA splits
        JAX's: each rank runs the sLSTM step (the step kernel), the mLSTM
        readout (q·n, q·C) and whisper's cross attention on its H / n
        heads, and its block of heads enters ``wo`` as its block of the
        contraction dim (``sharded_dot``'s ``cols``: nothing gathered where
        ``wo`` is row-parallel, the serve profile; all-gathered over
        ``model`` first in the train profile).  The recurrent states stay
        replicated over ``model`` (``cache_specs``): the sLSTM's new head
        blocks are all-gathered over ``model``; the mLSTM's elementwise
        state update runs whole on every rank.  ``params`` are best cut
        once into their pieces (``sharding.pieces``, as ``generate`` does):
        a whole leaf is cut here at every step.

        The weight leaves a step still all-gathers, each used other than
        as the right operand of a product by a token's rows:
          * a ``"rec"`` layer's conv taps ``conv_w`` (4, d), cut (data,
            model) in the train profile and (None, model) in the serve
            one: 32 KB a layer at recurrentgemma-9b's d = 4,096 in bf16
            (26 layers: 0.85 MB a step);
          * an MoE layer's ``router`` (d, E), replicated into JAX's
            ``shard_map`` too: 1.05 MB a layer at qwen3-moe-235b-a22b's
            d = 4,096, E = 128 in bf16;
          * the head's table over the axes of its feature dim (``data`` in
            the train profile), as JAX's ``_logits`` gathers it.
        The sLSTM's ``r_mat`` (H, hd, 4·hd) is replicated by its spec
        (xlstm-1.3b's: 4 × 512 × 2,048 in bf16, 8.4 MB a layer, on every
        cell already), as are the 1-D leaves: nothing is gathered."""
        cfg = self.cfg
        b = token.shape[0]
        split = bool(env.dp_axes) and b % env.dp_size == 0
        n = env.n_cells
        tp = env.tp_size

        def per_rank(heads, group=1):
            """(the heads each cell runs, each cell's block index): a
            ``model`` rank's H / n heads where n divides H into blocks of
            whole groups (``group`` heads share a K/V head), else all H."""
            hb = heads // tp
            if tp == 1 or heads % tp or (hb % group and group % hb):
                return heads, [0] * n
            return hb, [env.axis_index(c, "model") for c in range(n)]

        def dot(xs, w, cols=()):
            return sh.sharded_dot(xs, w, env, rows_split=split, cols=cols)

        def norm(q, xs):
            return sh.cellwise(lambda s, x: norm_apply(cfg, x, s),
                               sh.cell_trees(q, n), xs)

        def add(xs, ys):
            return sh.cellwise(torch.add, xs, ys)

        def store(c, names, states):  # each cell's new state into its cache
            for j, name in enumerate(names):
                c[name] = sh.Sharded([st[j] for st in states], c[name].spec)

        def mlp(q, hs):
            h = sh.cellwise(lambda g, u: glu(cfg, g, u), dot(hs, q["w_gate"]),
                            dot(hs, q["w_up"]))
            return dot(h, q["w_down"])

        def small(q):     # each cell's tree of the leaves no product takes
            return sh.cell_trees({k: t for k, t in q.items()
                                  if not isinstance(t, dict) and
                                  t[0].dim() != 2}, n)

        spec = sh.logical_spec((b, 1, cfg.d_model), ("dp", None, None), env)
        toks = sh.shard(token, spec[:2], env)
        xs = sh.cellwise(self._scale_embeds, sh.sharded_take(
            toks, sh.pieces({"embed": params["embed"]}, env)["embed"], env,
            rows_split=split))
        pos = torch.as_tensor(pos, dtype=torch.int32, device=env.first)
        poss = sh.cellwise(lambda x: pos.to(x.device).reshape(1), xs)
        for i, (kind, p, c) in enumerate(zip(self.kinds, params["layers"],
                                             caches)):
            lp = sh.pieces(p, env)
            if kind in ("attn", "local"):
                a = lp["attn"]
                hs = norm(lp["norm1"], xs)
                q, k, v = sh.unzip(sh.cellwise(
                    lambda p, q, k, v, ps: _qkv_heads(cfg, p, q, k, v, ps),
                    small(a), dot(hs, a["wq"]), dot(hs, a["wk"]),
                    dot(hs, a["wv"]), poss))
                if kind == "attn":
                    o = attn._decode_cells(q, c["k"], c["v"], k, v, pos, env)
                else:
                    o = self._grid_window_decode(c, q, k, v, pos, env)
                o = sh.cellwise(lambda o: o.reshape(o.shape[0], 1, cfg.q_dim),
                                o)
                xs = add(xs, dot(o, a["wo"]))
                if cfg.is_encoder_decoder:
                    lc = sh.pieces(params["cross_layers"][i], env)
                    qc = dot(norm(lc["norm"], xs), lc["attn"]["wq"])
                    hb, blk = per_rank(cfg.n_heads,
                                       cfg.n_heads // cfg.n_kv_heads)
                    o = self._grid_cross_decode(qc, c["cross_k"],
                                                c["cross_v"], hb, blk)
                    xs = add(xs, dot(o, lc["attn"]["wo"],
                                     "model" if hb < cfg.n_heads else ()))
                h2 = norm(lp["norm2"], xs)
                if not cfg.is_moe:
                    xs = add(xs, mlp(lp["mlp"], h2))
                    continue
                ys = moe._decode_cells(cfg, moe._expert_cells(lp["moe"], env),
                                       h2, env, batch_split=split)
                if cfg.n_shared_experts:
                    ys = add(ys, mlp(lp["shared_mlp"], h2))
                xs = add(xs, ys)
                continue
            hs = norm(lp["norm1"], xs)
            if kind == "rec":
                hs = sh.cellwise(lambda h: h[:, 0], hs)
                gate = sh.cellwise(act_fn("gelu"), dot(hs, lp["proj_gate"]))
                xin = dot(hs, lp["proj_in"])
                conv_w = lp["conv_w"]        # its taps are read whole
                if env.size(tuple(conv_w.spec)) > 1:
                    conv_w = sh.gather_whole(conv_w, None, env)
                y = sh.cellwise(rec.rglru_decode_conv, c["tail"], xin,
                                conv_w, lp["conv_b"])
                rg, ig = (dot(y, sh.Sharded(sh.cellwise(
                    lambda t: t.float(), lp[w]), lp[w].spec))
                    for w in ("w_rg", "w_ig"))
                out = sh.cellwise(rec.rglru_decode_gates,
                                  sh.cellwise(lambda *t: t, c["h"],
                                              c["tail"]),
                                  xin, y, rg, ig, lp["b_rg"], lp["b_ig"],
                                  lp["lam"])
                store(c, ("h", "tail"), [o[0] for o in out])
                o = sh.cellwise(lambda g, o: (g * o[1])[:, None], gate, out)
                xs = add(xs, dot(o, lp["wo"]))
                xs = add(xs, mlp(lp["mlp"], norm(lp["norm2"], xs)))
                continue
            # each cell runs its block of heads (all H where n does not
            # divide them), and the block enters wo as its rows
            hb, blk = per_rank(cfg.n_heads)
            split_heads = hb < cfg.n_heads
            if kind == "m":
                ins = sh.cellwise(
                    lambda p, *t: tuple(u[:, 0] for u in _mlstm_heads(
                        cfg, p, *t)), small(lp),
                    *(dot(hs, lp[w]) for w in ("wq", "wk", "wv", "w_if")))
                # the state update is elementwise: whole on every rank, so
                # the state (H·hd² floats a row) never crosses the grid
                new = sh.cellwise(lambda c_, n_, t: rec.mlstm_decode_update(
                    (c_, n_), *t[1:]), c["c"], c["n"], ins)
                store(c, ("c", "n"), new)
                o = sh.cellwise(
                    lambda t, st, m: rec.mlstm_decode_readout(
                        *(u[:, m * hb:(m + 1) * hb] for u in (t[0], *st))),
                    ins, new, blk)
            else:
                pre = sh.cellwise(lambda p, t: _slstm_heads(cfg, p, t)[:, 0],
                                  small(lp), dot(hs, lp["w_zifo"]))
                names = ("c", "n", "h", "m")

                def step(c_, n_, h_, m_, t, r, m):   # the step kernel
                    heads = slice(m * hb, (m + 1) * hb)
                    return rec.slstm_decode_step(
                        tuple(u[:, heads].contiguous()
                              for u in (c_, n_, h_, m_)),
                        t[:, :, heads], r[heads])

                out = sh.cellwise(step, *(c[k] for k in names), pre,
                                  lp["r_mat"], blk)
                states = [u[0] for u in out]
                if split_heads:    # back to cache_specs' replicated layout
                    states = list(zip(*(sh.all_gather(
                        [st[j] for st in states], env, "model", 1)
                        for j in range(4))))
                store(c, names, states)
                o = [u[1] for u in out]
            o = sh.cellwise(lambda o: o.reshape(o.shape[0], 1, -1), o)
            xs = add(xs, dot(o, lp["wo"], "model" if split_heads else ()))
        return self._grid_head(params, xs, env, split,
                               self._head_slices(params, env)), caches

    def _grid_cross_decode(self, qc: sh.Cells, ck: sh.Cells, cv: sh.Cells,
                           hb: int, blk: List[int]) -> sh.Cells:
        """Whisper's decode-step cross attention on the grid over the cached
        encoder K/V (replicated over ``model``): each cell runs block
        ``blk[c]`` of ``hb`` heads (``_grid_decode``'s ``per_rank``: a
        ``model`` rank's own heads, as XLA splits JAX's, or all of them) on
        views of its heads' cross K/V.  Returns o cells (B, 1, hb · hd)."""
        cfg = self.cfg
        g = cfg.n_heads // cfg.n_kv_heads
        kb = max(hb // g, 1)

        def block(q, k, v, m):
            lo = m * hb // g
            q = q.reshape(q.shape[0], 1, cfg.n_heads, cfg.hd)
            return attn.cross_decode_attention(
                q[:, :, m * hb:(m + 1) * hb], k[:, :, lo:lo + kb],
                v[:, :, lo:lo + kb]).reshape(q.shape[0], 1, hb * cfg.hd)

        return sh.cellwise(block, qc, ck, cv, blk)

    def _grid_window_decode(self, c: Dict[str, Any], q: sh.Cells,
                            k: sh.Cells, v: sh.Cells, pos, env: MeshEnv
                            ) -> sh.Cells:
        """A ``"local"`` layer's decode on the grid: the rolling window cut
        over ``model`` by ``cache_specs`` (when W divides) attended on its
        shards and combined by lse (``attention._window_decode_cells``), or
        a whole window ``window_decode_attention`` once per device; the
        new K/V and position written into the layer's cache in place."""
        kspec = c["k"].spec
        if len(kspec) > 1 and kspec[1] is not None:
            return attn._window_decode_cells(
                q, c["k"], c["v"], c["kpos"], k, v, pos, env,
                window=self.cfg.window)
        out = sh.cellwise(
            lambda q, kc, vc, kp, k, v: attn.window_decode_attention(
                q, kc, vc, kp, k, v, pos.to(q.device),
                window=self.cfg.window)[0],
            q, c["k"], c["v"], c["kpos"], k, v)
        return out


def _vocab_nll_chunk_sum(step: int, hs: List[torch.Tensor],
                         labels: List[torch.Tensor], *ws: torch.Tensor
                         ) -> torch.Tensor:
    """Σ NLL of one chunk of a data row's tokens with the vocabulary split
    over the ``model`` ranks: rank m's rows hs[m] (T, d) (the same tokens
    on its device) against its slice ws[m] (V / n, d) of the
    unembedding; the slices' log-sum-exps and the gold logit (from the
    slice that holds the label) combined in rank order on rank 0's
    device, where ``labels >= 0``."""
    dev0 = hs[0].device
    lses, gold = [], None
    for m, (h, lab, w) in enumerate(zip(hs, labels, ws)):
        lg = (h @ w.t()).float()
        local = lab.long() - m * step
        mine = (local >= 0) & (local < step)
        g = lg.gather(-1, local.clamp(0, step - 1)[:, None])[:, 0]
        g = torch.where(mine, g, torch.zeros_like(g)).to(dev0)
        lses.append(torch.logsumexp(lg, -1).to(dev0))
        gold = g if gold is None else gold + g
    lse = torch.logsumexp(torch.stack(lses), 0)
    return ((lse - gold) * (labels[0] >= 0).float()).sum()


def _nll_chunk_sum(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Σ NLL of ``labels`` over rows h (T, d) against the whole
    unembedding w (V, d), where ``labels >= 0``."""
    logits = (h @ w.t()).float()
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0).long()[:, None])[:, 0]
    return ((lse - gold) * mask).sum()


PORTED_KINDS = ("attn", "local", "rec", "m", "s")


def build_model(cfg: ArchConfig) -> Model:
    """A :class:`Model` for any config whose block kinds are ported (every
    arch of ``ARCHS``)."""
    kinds = set(cfg.layer_kinds())
    if kinds - set(PORTED_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: block kinds {sorted(kinds - set(PORTED_KINDS))} "
            f"are not ported (ported: {list(PORTED_KINDS)})")
    return Model(cfg)
