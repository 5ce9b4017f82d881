"""Plain PyTorch version of split-K flash decode: the counterpart of
``decode_attention_ref`` (``src/repro/kernels/flash_attention/ref.py:32``).
The CPU path and the tests use it; nothing on the CUDA path calls it."""
from __future__ import annotations

from typing import Union

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         pos: Union[int, torch.Tensor], *, window: int = 0,
                         return_lse: bool = False):
    """q: (B, 1, H, hd); caches: (B, S, KVH, hd); pos: the position of the
    new token (an int or a 0-d integer tensor).  Attends to the cache
    entries kpos <= pos (and kpos > pos - window) -> (B, 1, H, hd) in q's
    dtype, computed in float32.  With ``return_lse``: the output in float32,
    0 where no entry is live (pos < 0, or every entry below the window),
    and each head's log-sum-exp (B, 1, H), -inf there."""
    b, _, h, hd = q.shape
    kvh = k_cache.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, hd).float() * (hd ** -0.5)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    pos = torch.as_tensor(pos, device=q.device)
    valid = kpos <= pos
    if window > 0:
        valid &= kpos > pos - window
    s = torch.where(valid[None, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    if not return_lse:
        return out.reshape(b, 1, h, hd).to(q.dtype)
    if not bool(valid.any()):
        return (torch.zeros((b, 1, h, hd), device=q.device),
                torch.full((b, 1, h), -torch.inf, device=q.device))
    lse = torch.logsumexp(torch.where(
        valid[None, None, None, :], s, torch.full_like(s, -torch.inf)), -1)
    return out.reshape(b, 1, h, hd), lse.reshape(b, 1, h)
