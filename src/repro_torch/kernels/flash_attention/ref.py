"""Plain PyTorch version of GQA causal/windowed prefill attention: the
counterpart of ``flash_attention_ref``
(``src/repro/kernels/flash_attention/ref.py:9``).  The CPU path and the
tests use it; nothing on the CUDA path calls it."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, return_lse: bool = False):
    """q: (B, S, H, hd); k, v: (B, S, KVH, hd) -> (B, S, H, hd) in q's
    dtype, computed in float32.  Query i sits at position q_offset + i,
    key j at j.  With ``q_offset`` or ``return_lse`` a row that sees no
    key gives 0 (the kernel's output); with ``return_lse`` the output is
    float32 and comes with each row's log-sum-exp (B, S, H), -inf for
    such a row."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, hd).float() * (hd ** -0.5)
    scores = torch.einsum("bqkgd,bskd->bqkgs", qg, k.float())
    pos = torch.arange(s, device=q.device)
    d = (pos + q_offset)[:, None] - pos[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= d >= 0
    if window > 0:
        mask &= d < window
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bqkgs,bskd->bqkgd", p, v.float())
    if not (q_offset or return_lse):
        return out.reshape(b, s, h, hd).to(q.dtype)
    seen = mask.any(-1)                                     # (S,)
    out = torch.where(seen[None, :, None, None, None], out,
                      torch.zeros_like(out)).reshape(b, s, h, hd)
    if not return_lse:
        return out.to(q.dtype)
    lse = torch.logsumexp(torch.where(
        mask[:, None, None, :], scores,
        torch.full_like(scores, -torch.inf)), dim=-1)
    return out, lse.reshape(b, s, h)
