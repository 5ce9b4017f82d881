"""Model merging across a device grid — the paper's Alg. 1/2 as reductions.

Merging exponential-family sufficient statistics is a *reduction*, so
merging per-device partition models is an all-reduce over the data axis:

    MVB:  λ*   = η + Σ_d (λ_d − η)
    MGS:  N*kv = Σ_d decay^s_d · ΔN_kv_d

The JAX package runs these as ``psum`` inside ``shard_map``; the port
holds one tensor per data rank and reduces with
``sharding.all_reduce`` (added in rank order: the same bits every run).

``merge_topics_sharded`` / ``merge_topics_ragged_sharded`` are the
*query-path* merges behind ``ShardedDeviceBackend``: every model is
resident as contiguous vocabulary slices, one per model shard; each
shard merges its own (n, K, Vp/shards) slices with the merge kernels
by pointer table (``merge_topics_parts`` for one query,
``merge_topics_parts_segments`` for a batch), adds the family's finisher offset and masks the pad columns.
Only the (K,) — or (b, K) — row sums cross shards: added in shard order
on the first shard's device and sent back, each shard divides its slice
by them.  The masking, row sums and division are plain torch, as they
are plain ``jnp`` in the JAX package.  The JAX version pads K to a
multiple of 8 for the TPU's sublanes; the CUDA kernels take any K.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from repro_torch.distributed.sharding import MeshEnv, all_reduce
from repro_torch.kernels.merge_topics.ops import (
    merge_topics_parts,
    merge_topics_parts_segments,
)
from repro_torch.testing.faults import maybe_fail


def merge_vb_collective(lams: Sequence[torch.Tensor], eta: float,
                        env: MeshEnv,
                        weights: Optional[Sequence[float]] = None
                        ) -> List[torch.Tensor]:
    """``lams[d]``: data rank d's (K, V_shard) VB posterior.  Returns the
    merged λ, one copy per rank on its device.  ``weights[d]`` rescales
    rank d's contribution (the paper's doc-count weighting)."""
    _check_ranks(lams, env)
    deltas = [lam - eta for lam in lams]
    if weights is not None:
        deltas = [d * w for d, w in zip(deltas, weights)]
    return [eta + s for s in all_reduce(deltas)]


def merge_gs_collective(deltas: Sequence[torch.Tensor], env: MeshEnv,
                        decay: float = 1.0,
                        staleness: Optional[Sequence[float]] = None
                        ) -> List[torch.Tensor]:
    """``deltas[d]``: rank d's (K, V_shard) CGS ΔN_kv.  Returns the merged
    N_kv, one copy per rank; a stale rank (s > 0) is decayed by
    ``decay ** s`` first (DSGS, Eq. 9)."""
    _check_ranks(deltas, env)
    if staleness is not None:
        deltas = [d * decay ** float(s) for d, s in zip(deltas, staleness)]
    return all_reduce(list(deltas))


def _check_ranks(per_rank: Sequence[torch.Tensor], env: MeshEnv) -> None:
    if len(per_rank) != env.dp_size:
        raise ValueError(f"one tensor per data rank: {env.dp_size} ranks, "
                         f"got {len(per_rank)}")


def merge_stats(stats_per_device: torch.Tensor, env: MeshEnv,
                kind: str = "vb", eta: float = 0.01) -> torch.Tensor:
    """Host-callable merge of ``(n, K, V)`` statistics over the grid.

    The n rows split over the data ranks in contiguous blocks and the
    vocabulary over the model shards; each cell sums its block, the
    ranks' sums are all-reduced, and the result comes back as one (K, V)
    tensor on the first device.  Ported with the JAX module, whose
    callers are the LM training loops; nothing on MLego's query path
    calls it (the elastic repartitioner merges on the host).
    """
    if env.dp_size == 1:
        merged = stats_per_device.sum(0)
        return (eta + (merged - eta * stats_per_device.shape[0])
                if kind == "vb" else merged)
    n, _, v = stats_per_device.shape
    if n % env.dp_size or v % env.tp_size:
        raise ValueError(f"({n}, K, {v}) statistics do not split evenly "
                         f"over a {env.dp_size} x {env.tp_size} grid")
    rows = stats_per_device.chunk(env.dp_size, dim=0)
    cols = []
    for m in range(env.tp_size):
        local = []
        for d in range(env.dp_size):
            s = rows[d].chunk(env.tp_size, dim=-1)[m].to(env.devices[d][m])
            local.append((s - eta).sum(0) if kind == "vb" else s.sum(0))
        merged = all_reduce(local)[0]
        cols.append((eta + merged if kind == "vb" else merged).to(env.first))
    return torch.cat(cols, dim=-1)


# ---------------------------------------------------------------------------
# vocab-sharded query merges: each model shard owns a Vp/shards slice
# ---------------------------------------------------------------------------

def padded_vocab(v: int, shards: int) -> int:
    """V rounded up to a multiple of ``shards`` × 128, as in the JAX
    package (its slices are f32-lane aligned).  The CUDA kernels need no
    such alignment; the width is kept so that a slice's bytes, and the
    cache budgets counted in them, are the same in both packages."""
    tile = shards * 128
    return ((v + tile - 1) // tile) * tile


def _masked_numerator(merged: torch.Tensor, num_offset: float, v_true: int,
                      col0: int) -> torch.Tensor:
    """merged slice -> finisher numerator with pad columns zeroed.

    ``col0`` is the slice's first global column.  Pad columns carry
    ``bias`` out of the kernel; adding ``num_offset`` makes them nonzero
    for both families — mask them before they reach the row sums.
    """
    col = col0 + torch.arange(merged.shape[-1], device=merged.device)
    return torch.where(col < v_true, merged + num_offset,
                       torch.zeros((), dtype=merged.dtype,
                                   device=merged.device))


def _normalize(nums: List[torch.Tensor]) -> List[torch.Tensor]:
    """Divide every shard's numerator by the row sums over all shards."""
    norms = all_reduce([num.sum(dim=-1) for num in nums])
    return [num / norm.unsqueeze(-1) for num, norm in zip(nums, norms)]


def _check_shards(per_shard: Sequence, env: MeshEnv) -> None:
    if len(per_shard) != env.tp_size:
        raise ValueError(f"one slice list per model shard: {env.tp_size} "
                         f"shards, got {len(per_shard)}")


def merge_topics_sharded(parts: Sequence[Sequence[torch.Tensor]],
                         weights: Union[Sequence[float], torch.Tensor],
                         env: MeshEnv, *, bias: float, base: float,
                         num_offset: float, v_true: int
                         ) -> List[torch.Tensor]:
    """One query's merge with the vocabulary sharded over ``env``'s
    model axis.

    ``parts[s]`` holds the n (K, Vp/shards) contiguous slices of shard s
    (on ``env.devices[0][s]``), with Vp = padded_vocab(V, shards);
    ``weights`` are the n part weights.  Each shard merges its slice in
    one kernel launch.  Returns the topic matrix β as one (K, Vp/shards)
    slice per shard; concatenate them and keep ``[:, :v_true]``.
    """
    maybe_fail("collective.merge")
    _check_shards(parts, env)
    vs = parts[0][0].shape[-1]
    nums = [_masked_numerator(
        merge_topics_parts(slices, weights, bias=bias, base=base),
        num_offset, v_true, s * vs) for s, slices in enumerate(parts)]
    return _normalize(nums)


def merge_topics_ragged_sharded(rows: Sequence[Sequence[torch.Tensor]],
                                weights: Sequence[float],
                                counts: Sequence[int], env: MeshEnv, *,
                                bias: float, base: float, num_offset: float,
                                v_true: int) -> List[torch.Tensor]:
    """A ragged batch of vocab-sharded merges: one launch per shard.

    ``rows[s]`` holds every query's part slices of shard s, concatenated
    in query order (CSR); ``counts`` gives each query's number of rows
    and ``weights`` the R row weights.  Each shard merges its rows where
    they lie, in one segmented launch by pointer table; the cross-shard
    row sums are (b, K), independent of V.  Returns β as one (b, K, Vp/shards)
    slice per shard.
    """
    maybe_fail("collective.merge")
    _check_shards(rows, env)
    vs = rows[0][0].shape[-1]
    nums = []
    for s, slices in enumerate(rows):
        merged = merge_topics_parts_segments(list(slices), counts,
                                             list(weights), bias, base)
        nums.append(_masked_numerator(merged, num_offset, v_true, s * vs))
    return _normalize(nums)
