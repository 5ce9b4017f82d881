"""Mixture-of-Experts FFN, on one device and with expert parallelism.

The port of ``src/repro/models/moe.py``, plain functions on tensors:

  * ``moe_dispatch`` (prefill and training) — top-k routing, then every (token,
    choice) pair scattered into its expert's capacity buffer (E, cap, d)
    at its position among that expert's pairs in token order; pairs past
    ``cap`` are dropped, as JAX's ``mode="drop"`` scatter drops them; the
    expert FFN as three batched products over the buffers; each pair's
    output gathered back, weighted by its gate and summed over the k
    choices;
  * ``moe_decode`` (one token per sequence) — the same routing; each
    pair's expert weights gathered (``wg[ids]``, JAX's ``wg_l[sel_exp]``)
    and applied by batched vector–matrix products.  On one device JAX's
    decode capacity, max(4, round(2·B·k)), exceeds the B·k pairs, so no
    pair is dropped and the port keeps no capacity here.

The products are library ones (``torch.bmm``), as JAX computes them in
jnp outside any Pallas kernel.  ``moe_dispatch`` differentiates as it
stands (autograd takes its in-place copy, fill and gate product): the
gradients reach the router through the gates and the aux loss, and the
experts, as ``jax.grad`` gives them.

On a grid (``env``; JAX's ``shard_map`` branches) the experts are split
over ``model`` (E / n a cell) and d_ff over ``data``, the expert weights'
layout under ``infer_param_specs``:

  * ``moe_dispatch`` — the tokens are sharded (batch over ``data``,
    sequence over ``model``); each cell routes its own tokens into (E,
    cap, d) capacity buffers with cap = max(4, round(t_loc·k/E·cf)) of
    its t_loc tokens, the buffers' expert blocks are exchanged by one
    ``all_to_all`` over ``model``, each cell runs its E / n experts with
    their d_ff slices all-gathered over ``data`` in the compute dtype, and
    a second ``all_to_all`` sends the outputs back;
  * ``moe_decode`` — the batch rows are all-gathered over ``data``; cell
    (d, m) takes the (token, choice) pairs routed to its experts, local
    pairs first by a stable sort, up to cap = max(4, round(B·k/n·2)),
    computes them on its d_ff slice, the partial products are summed over
    ``data`` and the pair outputs over ``model`` (rank order), and each
    cell keeps its own batch rows;
  * ``_aux_loss`` — the counts, probability sums and token totals summed
    over every cell before the loss is formed.

Capacity is per cell, not per model, so with drops the grid's result is
JAX's sharded result on the same grid shape, not the one-device one.

Numerics, as JAX: the router runs in float32 from the (bf16-cast)
router weights; ties in the top-k put the lower expert first
(``jax.lax.top_k``'s order, here a stable descending sort); the gates
are renormalised by max(sum, 1e-9); the products run in the model dtype
and the gates are cast to it before they weight the pairs.  The sum over
the k choices is one reduction (JAX's decode scatter-adds the pairs one
by one in the model dtype): the same in float32 up to rounding.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import MeshEnv
from repro_torch.models.layers import act_fn, dense_init

Params = Dict[str, torch.Tensor]


def moe_init(cfg: ArchConfig, gen: torch.Generator,
             dtype: torch.dtype = torch.float32) -> Params:
    """The router (d, E) N(0, 1/d), ``expert_w_gate`` and ``expert_w_up``
    (E, d, f) N(0, 1/d) and ``expert_w_down`` (E, f, d) N(0, 1/f), JAX's
    distributions, drawn in float32 on ``gen.device`` and each cast to
    ``dtype`` as soon as it is drawn (the same draws as casting after;
    only one float32 expert tensor exists at a time)."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    dev = gen.device

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev).mul_(fan_in ** -0.5)
        return w.to(dtype)

    return {
        "router": dense_init(gen, d, e).to(dtype),
        "expert_w_gate": normal((e, d, f), d),
        "expert_w_up": normal((e, d, f), d),
        "expert_w_down": normal((e, f, d), f),
    }


def _route(x_f32: torch.Tensor, router_w: torch.Tensor, top_k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (t, d) float32.  Returns gates (t, k) float32, ids (t, k) int64
    and probs (t, E) float32 (``moe.py:47``)."""
    logits = x_f32 @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k puts the lower index first on ties; torch.topk
    # promises no order, a stable descending sort keeps the index order
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :top_k], ids[:, :top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, ids, probs


def _aux_parts(probs: torch.Tensor, ids: torch.Tensor, n_experts: int):
    """One cell's (pairs routed to each expert, summed router
    probabilities, pair count)."""
    t, k = ids.shape
    frac = torch.zeros(n_experts, dtype=torch.float32, device=probs.device)
    frac.index_add_(0, ids.reshape(-1),
                    torch.ones(t * k, dtype=torch.float32,
                               device=probs.device))
    return frac, probs.sum(0), float(t * k)


def _aux_loss(probs, ids, n_experts: int,
              env: Optional[MeshEnv] = None) -> torch.Tensor:
    """The Switch-style load-balance loss (``moe.py:56``): E · Σ_e (pairs
    routed to e / pairs) · (mean router probability of e).  With ``env``,
    probs and ids are cell lists and the counts, sums and totals are
    added over every cell in rank order first (JAX's psum over all
    axes); the loss lands on the first cell's device."""
    k = (ids[0] if env is not None else ids).shape[1]
    if env is None:
        frac, p_sum, t_tot = _aux_parts(probs, ids, n_experts)
    else:
        parts = [_aux_parts(p, i, n_experts) for p, i in zip(probs, ids)]
        dev = env.first
        frac = sh.all_reduce([f.to(dev) for f, _, _ in parts])[0]
        p_sum = sh.all_reduce([p.to(dev) for _, p, _ in parts])[0]
        t_tot = sum(t for _, _, t in parts)
    return n_experts * torch.sum((frac / t_tot) * (p_sum / (t_tot / k)))


def capacity_positions(flat_ids: torch.Tensor, n_experts: int
                       ) -> torch.Tensor:
    """Each pair's position among the pairs of its expert, in pair order:
    a stable argsort of the flat expert ids minus the exclusive prefix of
    the per-expert counts (``moe.py:105-109``).  No host round trip."""
    n = flat_ids.shape[0]
    order = torch.argsort(flat_ids, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=flat_ids.device)
    counts.scatter_add_(0, flat_ids, torch.ones_like(flat_ids))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(n, device=flat_ids.device) - \
        starts[flat_ids[order]]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Pairs each expert's buffer holds in ``moe_dispatch``: JAX's
    expression (``moe.py:98``), Python's ``round`` (halves to even)
    included."""
    return int(max(4, round(n_tokens * cfg.moe_top_k / cfg.n_experts
                            * cfg.capacity_factor)))


def _expert_ffn(cfg: ArchConfig, tokens: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """tokens (E, C, d); weights (E, d, f), (E, f, d) in tokens' dtype ->
    (E, C, d) (``moe.py:69``)."""
    act = act_fn(cfg.act)
    h = act(torch.bmm(tokens, w_gate)) * torch.bmm(tokens, w_up)
    return torch.bmm(h, w_down)


def _pack(cfg: ArchConfig, x: torch.Tensor, router: torch.Tensor):
    """Route x (B, S, d) and pack its (token, choice) pairs into (E, cap,
    d) capacity buffers: (buf, (gates, flat_ids, pos, keep), probs, ids,
    cap).  Pairs past ``cap`` are dropped."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    t = b * s
    xt = x.reshape(t, d)
    gates, ids, probs = _route(xt.float(), router, k)
    cap = capacity(cfg, t)
    flat_ids = ids.reshape(-1)
    pos = capacity_positions(flat_ids, e)
    keep = pos < cap
    # slot of each pair in the flat (E·cap, d) buffer; dropped pairs go to
    # one spare row past the end, never read
    slot = torch.where(keep, flat_ids * cap + pos,
                       torch.full_like(pos, e * cap))
    buf = x.new_zeros((e * cap + 1, d))
    for col in slot.view(t, k).unbind(1):
        buf.index_copy_(0, col, xt)
    return (buf[:e * cap].view(e, cap, d), (gates, flat_ids, pos, keep),
            probs, ids, cap)


def _unpack(y_e: torch.Tensor, pairs, cap: int, shape) -> torch.Tensor:
    """Each pair's expert output out of (E, cap, d), weighted by its gate
    and summed over the k choices -> (B, S, d)."""
    gates, flat_ids, pos, keep = pairs
    b, s, d = shape
    vals = y_e.reshape(-1, d).index_select(
        0, flat_ids * cap + pos.clamp(max=cap - 1))
    vals.masked_fill_(~keep[:, None], 0.0)
    vals = vals.view(b * s, gates.shape[1], d).mul_(
        gates.to(y_e.dtype)[..., None])
    return vals.sum(1).reshape(b, s, d)


def moe_dispatch(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
                 env: Optional[MeshEnv] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux loss) (``moe.py:90-148``).  The
    expert weights must already be in x's dtype (``Model.cast_params``).
    With ``env``: expert parallelism (``_dispatch_cells``), x sharded
    (batch over ``data``, sequence over ``model``), the expert weights by
    their ``infer_param_specs`` layout."""
    if env is not None:
        xspec = sh.seq_spec(env, x.shape[0], 3)
        ys, aux = _dispatch_cells(cfg, _expert_cells(p, env),
                                  sh.shard(x, xspec, env), env)
        return sh.unshard(ys, xspec, env), aux
    buf, pairs, probs, ids, cap = _pack(cfg, x, p["router"])
    aux = _aux_loss(probs, ids, cfg.n_experts)
    y_e = _expert_ffn(cfg, buf, p["expert_w_gate"], p["expert_w_up"],
                      p["expert_w_down"])
    return _unpack(y_e, pairs, cap, x.shape), aux


EXPERT_KEYS = ("expert_w_gate", "expert_w_up", "expert_w_down")


def _expert_cells(p: Params, env: MeshEnv) -> Dict[str, sh.Cells]:
    """The MoE weights as cell lists: the router whole on every cell (JAX
    passes it replicated into ``shard_map``), the expert tensors cut by
    their ``infer_param_specs`` layout (E over ``model``, d_ff over
    ``data``).  Leaves that are cell lists already pass as they are."""
    specs = sh.infer_param_specs(
        {"moe": {k: p[k] for k in EXPERT_KEYS if not isinstance(p[k], list)}},
        env)["moe"]
    out = {}
    for name, t in p.items():
        if name == "router":
            out[name] = (sh.gather_whole(t, None, env) if isinstance(t, list)
                         else sh.replicate(t, env))
        elif isinstance(t, list):
            out[name] = t
        else:
            out[name] = sh.shard(t, specs[name], env)
    return out


def _gathered_experts(pc: Dict[str, sh.Cells], env: MeshEnv):
    """The cells' expert weights with d_ff all-gathered over ``data``
    (gate/up on their last axis, down on its middle one)."""
    if "data" not in env.axis_names or env.size("data") == 1:
        return [pc[k] for k in EXPERT_KEYS]
    return [sh.all_gather(pc["expert_w_gate"], env, "data", 2),
            sh.all_gather(pc["expert_w_up"], env, "data", 2),
            sh.all_gather(pc["expert_w_down"], env, "data", 1)]


def _dispatch_cells(cfg: ArchConfig, pc: Dict[str, sh.Cells],
                    xs: sh.Cells, env: MeshEnv
                    ) -> Tuple[sh.Cells, torch.Tensor]:
    """``moe_dispatch`` on one tensor per cell (``moe.py:82``).  pc: the
    router whole and the expert pieces, as cell lists.  Returns (y cells,
    the aux loss on the first cell's device)."""
    n = env.tp_size
    e = cfg.n_experts
    e_loc = max(e // n, 1)
    packed = sh.cellwise(lambda x, r: _pack(cfg, x, r), xs, pc["router"])
    aux = _aux_loss([pk[2] for pk in packed], [pk[3] for pk in packed], e,
                    env)
    bufs = sh.cellwise(lambda pk: pk[0], packed)
    cap = packed[0][4]
    d = xs[0].shape[-1]
    if n > 1:
        # (n · E_loc, cap, d): the owner ranks' expert blocks exchanged
        recv = sh.all_to_all(bufs, env, "model", 0, 0)
        tokens = sh.cellwise(
            lambda r: r.view(n, e_loc, cap, d).transpose(0, 1).reshape(
                e_loc, n * cap, d), recv)
    else:
        tokens = bufs
    wg, wu, wd = _gathered_experts(pc, env)
    y_e = sh.cellwise(lambda t, g, u, w: _expert_ffn(cfg, t, g, u, w),
                      tokens, wg, wu, wd)
    if n > 1:
        y_e = sh.cellwise(
            lambda y: y.view(e_loc, n, cap, d).transpose(0, 1).reshape(
                n * e_loc, cap, d), y_e)
        y_e = sh.all_to_all(y_e, env, "model", 0, 0)
    ys = sh.cellwise(lambda y, pk, x: _unpack(y, pk[1], cap, x.shape),
                     y_e, packed, xs)
    return ys, aux


def moe_decode(cfg: ArchConfig, p: Params, x: torch.Tensor, *,
               env: Optional[MeshEnv] = None) -> torch.Tensor:
    """x: (B, 1, d) -> y (B, 1, d) (``moe.py:179-219``): every (token,
    choice) pair through its own expert, by the pair's gathered weights
    (3 · B·k · d · f elements copied a call).  The expert weights must
    already be in x's dtype.  With ``env``: the experts split over
    ``model`` and d_ff over ``data`` (``_decode_cells``)."""
    if env is not None:
        xspec = sh.seq_spec(env, x.shape[0], 3, seq=False)
        ys = _decode_cells(cfg, _expert_cells(p, env),
                           sh.shard(x, xspec, env), env,
                           batch_split=xspec[0] is not None)
        return sh.unshard(ys, xspec, env)
    b, _, d = x.shape
    k = cfg.moe_top_k
    xt = x.reshape(b, d)
    gates, ids, _ = _route(xt.float(), p["router"], k)
    flat_ids = ids.reshape(-1)
    wg, wu, wd = (p[name].index_select(0, flat_ids) for name in
                  ("expert_w_gate", "expert_w_up", "expert_w_down"))
    toks = xt.repeat_interleave(k, dim=0)[:, None]         # (B·k, 1, d)
    act = act_fn(cfg.act)
    h = act(torch.bmm(toks, wg)) * torch.bmm(toks, wu)
    y_pair = torch.bmm(h, wd)[:, 0] * gates.reshape(-1, 1).to(x.dtype)
    return y_pair.view(b, k, d).sum(1)[:, None]


def _decode_cells(cfg: ArchConfig, pc: Dict[str, sh.Cells], xs: sh.Cells,
                  env: MeshEnv, *, batch_split: bool) -> sh.Cells:
    """``moe_decode`` on one tensor per cell (``moe.py:170``): the batch
    rows all-gathered over ``data``; cell (d, m) computes the pairs routed
    to its E / n experts, local pairs first by a stable sort, up to cap =
    max(4, round(B·k/n·2)), on its d_ff slice; the partial products are
    summed over ``data``, gated, the pair outputs summed over ``model`` (in
    rank order both), and each cell keeps its own batch rows.
    ``batch_split``: the rows are cut over ``data`` (else each cell holds
    them all)."""
    n = env.tp_size
    e, k = cfg.n_experts, cfg.moe_top_k
    e_loc = max(e // n, 1)
    b_loc, _, d = xs[0].shape
    dp = env.dp_axes
    xt = sh.cellwise(lambda x: x.reshape(b_loc, d), xs)
    if batch_split and env.dp_size > 1:
        xt = sh.all_gather(xt, env, dp, 0)
    b_all = xt[0].shape[0]
    cap = int(max(4, round(b_all * k / max(n, 1) * 2)))
    act = act_fn(cfg.act)

    def pairs(x, router, wg, wu, wd, r):
        gates, ids, _ = _route(x.float(), router, k)
        lo = r * e_loc
        flat_ids = ids.reshape(-1)
        is_local = (flat_ids >= lo) & (flat_ids < lo + e_loc)
        order = torch.argsort((~is_local).to(torch.int8), stable=True)
        sel = order[:cap]
        valid = is_local[sel]
        exp = (flat_ids[sel] - lo).clamp(0, e_loc - 1)
        toks = x.index_select(0, torch.div(sel, k, rounding_mode="floor"))
        toks = toks[:, None]                                  # (cap, 1, d)
        h = act(torch.bmm(toks, wg.index_select(0, exp))) * torch.bmm(
            toks, wu.index_select(0, exp))
        y = torch.bmm(h, wd.index_select(0, exp))[:, 0]       # (cap, d)
        gate = torch.where(valid, gates.reshape(-1)[sel],
                           torch.zeros_like(gates.reshape(-1)[sel]))
        return y, gate, sel, valid

    ranks = [env.axis_index(c, "model") for c in range(env.n_cells)]
    made = sh.cellwise(pairs, xt, pc["router"], pc["expert_w_gate"],
                       pc["expert_w_up"], pc["expert_w_down"], ranks)
    ys = [m[0] for m in made]
    if "data" in env.axis_names and env.size("data") > 1:
        ys = sh.psum(ys, env, "data")         # the d_ff slices' partials

    def place(y, m, x):
        _, gate, sel, valid = m
        y = y * gate[:, None].to(y.dtype)
        y = torch.where(valid[:, None], y, torch.zeros_like(y))
        out = y.new_zeros((b_all * k, d))
        out.index_copy_(0, sel, y)
        return out.view(b_all, k, d).sum(1)

    y_all = sh.cellwise(place, ys, made, xt)
    if n > 1:
        y_all = sh.psum(y_all, env, "model")
    if b_all == b_loc:
        return sh.cellwise(lambda y: y.reshape(b_loc, 1, d), y_all)
    rows = [env.axis_index(c, dp) for c in range(env.n_cells)]
    return sh.cellwise(
        lambda y, i: y[i * b_loc:(i + 1) * b_loc].reshape(b_loc, 1, d),
        y_all, rows)
