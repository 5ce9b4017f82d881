"""Mixture-of-Experts FFN, single-device forms.

The port of ``src/repro/models/moe.py``'s one-device paths, plain
functions on tensors:

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
experts, as ``jax.grad`` gives them.  The expert-parallel ``shard_map``
branches and their ``all_to_all`` wait for ROADMAP.md Queue 1 item 6.

Numerics, as JAX: the router runs in float32 from the (bf16-cast)
router weights; ties in the top-k put the lower expert first
(``jax.lax.top_k``'s order, here a stable descending sort); the gates
are renormalised by max(sum, 1e-9); the products run in the model dtype
and the gates are cast to it before they weight the pairs.  The sum over
the k choices is one reduction (JAX's decode scatter-adds the pairs one
by one in the model dtype): the same in float32 up to rounding.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
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


def _aux_loss(probs: torch.Tensor, ids: torch.Tensor, n_experts: int
              ) -> torch.Tensor:
    """The Switch-style load-balance loss of one device (``moe.py:56``
    with no mesh axes): E · Σ_e (pairs routed to e / pairs) · (mean
    router probability of e)."""
    t, k = ids.shape
    frac = torch.zeros(n_experts, dtype=torch.float32, device=probs.device)
    frac.index_add_(0, ids.reshape(-1),
                    torch.ones(t * k, dtype=torch.float32,
                               device=probs.device))
    t_tot = float(t * k)
    return n_experts * torch.sum((frac / t_tot) * (probs.sum(0) / (t_tot / k)))


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


def moe_dispatch(cfg: ArchConfig, p: Params, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux loss) (``moe.py:90-148``).  The
    expert weights must already be in x's dtype (``Model.cast_params``)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    t = b * s
    xt = x.reshape(t, d)
    gates, ids, probs = _route(xt.float(), p["router"], k)
    aux = _aux_loss(probs, ids, e)
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
    y_e = _expert_ffn(cfg, buf[:e * cap].view(e, cap, d),
                      p["expert_w_gate"], p["expert_w_up"],
                      p["expert_w_down"])
    vals = y_e.view(e * cap, d).index_select(
        0, flat_ids * cap + pos.clamp(max=cap - 1))
    vals.masked_fill_(~keep[:, None], 0.0)
    vals = vals.view(t, k, d).mul_(gates.to(x.dtype)[..., None])
    return vals.sum(1).reshape(b, s, d), aux


def moe_decode(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 1, d) -> y (B, 1, d) (``moe.py:179-219``): every (token,
    choice) pair through its own expert, by the pair's gathered weights
    (3 · B·k · d · f elements copied a call).  The expert weights must
    already be in x's dtype."""
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
