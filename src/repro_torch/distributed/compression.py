"""Gradient / sufficient-statistic compression for data-parallel sums.

The port of ``src/repro/distributed/compression.py``.  Two codecs,
composable with error feedback (the residual of what compression dropped
is carried into the next step, so compressed SGD still converges):

  * ``int8`` — per-tensor symmetric quantization: an 8× smaller payload;
  * ``topk`` — magnitude top-k sparsification (a dense payload with zeros
    elsewhere, summable as it is).

JAX's ``compressed_psum`` runs inside ``shard_map`` and sums with
``lax.psum``.  The port is single-controller, as ``distributed/
sharding.py`` is: ``compressed_psum`` takes one tensor per data rank (a
cell of a ``MeshEnv`` grid, on that cell's device), encodes each, and
sums the payloads with ``sharding.all_reduce`` in rank order, so a run
gives the same bits every time.  int8 payloads are summed in int32
(quantized sums stay exact until decode), against the largest scale of
the ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import all_reduce
from repro_torch.train.optim import leaves, unflatten


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    codec: str = "none"          # none | int8 | topk
    topk_frac: float = 0.01      # fraction of entries kept by topk
    error_feedback: bool = True


def int8_encode(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale): x ≈ q · scale, scale = max|x| / 127 + 1e-30."""
    scale = x.abs().max() / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def topk_sparsify(x: torch.Tensor, frac: float) -> torch.Tensor:
    """x with every entry below the k-th largest magnitude zeroed,
    k = max(1, int(numel · frac)) (ties at the threshold kept)."""
    flat = x.reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    return torch.where(x.abs() >= thresh, x, torch.zeros_like(x))


def compressed_psum(grads: Sequence[torch.Tensor],
                    residuals: Optional[Sequence[torch.Tensor]],
                    cfg: CompressionConfig
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """All-reduce one gradient per rank with compression.  ``residuals``:
    each rank's carried residual, or None.  Returns (each rank's copy of
    the sum, each rank's new residual), on the ranks' devices."""
    gs = [g.float() for g in grads]
    if cfg.error_feedback and residuals is not None:
        gs = [g + r for g, r in zip(gs, residuals)]

    if cfg.codec == "none":
        return all_reduce(gs), [torch.zeros_like(g) for g in gs]

    if cfg.codec == "int8":
        # re-quantize every rank against the largest scale, so the int32
        # sum decodes exactly
        scales = [int8_encode(g)[1] for g in gs]
        smax = scales[0]
        for s in scales[1:]:
            smax = torch.maximum(smax, s.to(smax.device))
        qs = [torch.clamp(torch.round(g / smax.to(g.device)), -127, 127
                          ).to(torch.int32) for g in gs]
        total = all_reduce(qs)
        out = [t.float() * smax.to(t.device) for t in total]
        return out, [g - q.float() * smax.to(g.device)
                     for g, q in zip(gs, qs)]

    if cfg.codec == "topk":
        sparse = [topk_sparsify(g, cfg.topk_frac) for g in gs]
        return all_reduce(sparse), [g - s for g, s in zip(gs, sparse)]

    raise ValueError(f"unknown codec {cfg.codec!r}")


def tree_compressed_psum(grads: Sequence[Any],
                         residuals: Optional[Sequence[Any]],
                         cfg: CompressionConfig
                         ) -> Tuple[List[Any], List[Any]]:
    """``compressed_psum`` leaf by leaf over one gradient tree per rank
    (nested dicts and lists); residuals may be None on the first step.
    Returns (one summed tree per rank, one residual tree per rank)."""
    flats = [leaves(g) for g in grads]
    res = [leaves(r) for r in residuals] if residuals is not None \
        else [[None] * len(flats[0]) for _ in grads]
    out = [[] for _ in grads]
    new_res = [[] for _ in grads]
    for j in range(len(flats[0])):
        rj = None if residuals is None else [r[j] for r in res]
        s, r = compressed_psum([f[j] for f in flats], rj, cfg)
        for i in range(len(grads)):
            out[i].append(s[i])
            new_res[i].append(r[i])
    return ([unflatten(g, o) for g, o in zip(grads, out)],
            [unflatten(g, r) for g, r in zip(grads, new_res)])
