"""Public wrappers of the merge kernels (``csrc/merge_topics.cu``).

Source note.  ``merge_topics`` replaces the Pallas kernel
``merge_topics_pallas`` (``src/repro/kernels/merge_topics/
merge_topics.py:37``) and ``merge_topics_ragged`` replaces
``merge_topics_ragged_pallas`` (same file, :112).  Both are bound by
device memory: the merge reads each of the n (K, V) float32 statistics
once and writes the result once, (n+1)·K·V·4 bytes, for ~2 flops per
element read.  The kernels keep each output element's running sum in a
register, read the inputs with 16-byte loads where K·V allows, and
touch no byte twice.  The ragged form gives each (segment, output tile)
its own program, looping over the segment's rows from CSR offsets built
on the host: no atomics, one launch, zero pad rows, the same sum order
on every run.  Unlike the TPU wrapper there is no padding of K to 8 or
V to 128; the kernel masks the flat K·V range itself.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA
tensor goes to the kernel or raises.  ``merge_topics_launches`` and
``merge_topics_ragged_launches`` count kernel launches.
"""
from __future__ import annotations

import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels.merge_topics.ref import (
    merge_topics_ref,
    merge_topics_segments_ref,
)

merge_topics_launches = 0
merge_topics_ragged_launches = 0
_count_lock = threading.Lock()


def _count(name: str) -> None:
    with _count_lock:
        globals()[name] += 1


def _check(stats: torch.Tensor, weights: torch.Tensor) -> None:
    if stats.dim() != 3:
        raise ValueError(f"stats must be (n, K, V), got {tuple(stats.shape)}")
    if weights.shape != (stats.shape[0],):
        raise ValueError(f"weights must be ({stats.shape[0]},), got "
                         f"{tuple(weights.shape)}")
    if stats.device != weights.device:
        raise ValueError(f"stats on {stats.device} but weights on "
                         f"{weights.device}")
    if stats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {stats.device}")


def merge_topics(stats: torch.Tensor, weights: torch.Tensor,
                 bias: float = 0.0, base: float = 0.0) -> torch.Tensor:
    """stats (n, K, V) f32, weights (n,) f32 -> (K, V) f32."""
    _check(stats, weights)
    if stats.device.type == "cpu":
        return merge_topics_ref(stats, weights, bias, base)
    dev = stats.device
    common.require_cuda_f32("stats", stats, dev)
    common.require_cuda_f32("weights", weights, dev)
    n, k, v = stats.shape
    out = torch.empty((k, v), dtype=torch.float32, device=dev)
    lib = common.load_library()
    status = lib.mlego_merge_topics(
        stats.data_ptr(), weights.data_ptr(), out.data_ptr(), n, k * v,
        float(bias), float(base), common.stream_of(stats))
    common.check_launch(status, "merge_topics")
    _count("merge_topics_launches")
    return out


def merge_topics_segments(stats: torch.Tensor, weights: torch.Tensor,
                          counts: Sequence[int], bias: float = 0.0,
                          base: float = 0.0) -> torch.Tensor:
    """Segmented merge of one (R, K, V) row stack, rows grouped by
    ``counts`` -> (len(counts), K, V), in one launch."""
    _check(stats, weights)
    counts = [int(c) for c in counts]
    if sum(counts) != stats.shape[0] or min(counts, default=0) < 1:
        raise ValueError(f"counts {counts} must be >= 1 and sum to "
                         f"{stats.shape[0]} rows")
    if stats.device.type == "cpu":
        return merge_topics_segments_ref(stats, weights, counts, bias, base)
    dev = stats.device
    common.require_cuda_f32("stats", stats, dev)
    common.require_cuda_f32("weights", weights, dev)
    _, k, v = stats.shape
    # pinned, so the copy is queued on the stream instead of blocking
    # the host until the device has drained earlier work
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                           dtype=torch.int32).pin_memory().to(
                               dev, non_blocking=True)
    out = torch.empty((len(counts), k, v), dtype=torch.float32, device=dev)
    lib = common.load_library()
    status = lib.mlego_merge_topics_ragged(
        stats.data_ptr(), weights.data_ptr(), offsets.data_ptr(),
        out.data_ptr(), len(counts), k * v, float(bias), float(base),
        common.stream_of(stats))
    common.check_launch(status, "merge_topics_ragged")
    _count("merge_topics_ragged_launches")
    return out


def segment_ids(counts: Sequence[int]) -> torch.Tensor:
    """CSR row->segment map for a ragged batch: (sum(counts),) int32."""
    return torch.from_numpy(
        np.repeat(np.arange(len(counts)), list(counts)).astype(np.int32))


def merge_topics_ragged(stats_list: Sequence[torch.Tensor],
                        weights_list: Sequence[torch.Tensor],
                        bias: float = 0.0, base: float = 0.0
                        ) -> Tuple[List[torch.Tensor], int, int]:
    """Ragged batch of merges: one segmented launch, zero pad rows.

    ``stats_list[i]`` is query i's ``(n_i, K, V)`` stack,
    ``weights_list[i]`` its ``(n_i,)`` weights.  The stacks concatenate
    into one ``(R, K, V)`` row stack (a copy) merged in one launch.
    Returns ``(merged, pad_rows, launches)``: ``pad_rows`` is always 0
    and ``launches`` always 1.
    """
    counts = [int(s.shape[0]) for s in stats_list]
    if len(counts) == 1:
        return [merge_topics(stats_list[0], weights_list[0],
                             bias=bias, base=base)], 0, 1
    stats = torch.cat(list(stats_list), dim=0)
    weights = torch.cat([w.to(torch.float32) for w in weights_list])
    merged = merge_topics_segments(stats, weights, counts, bias, base)
    return list(merged.unbind(0)), 0, 1


def merge_vb_stats(lams: torch.Tensor, weights: torch.Tensor,
                   eta: float) -> torch.Tensor:
    """Alg. 1: λ* = η + Σ w_i (λ_i − η).  lams: (n, K, V)."""
    return merge_topics(lams, weights, bias=eta, base=eta)


def merge_gs_stats(deltas: torch.Tensor, staleness: torch.Tensor,
                   decay: float) -> torch.Tensor:
    """Alg. 2: N* = Σ decay^{s_i} ΔN_i.  deltas: (n, K, V)."""
    w = (decay ** staleness.to(torch.float32)).to(deltas.device)
    return merge_topics(deltas, w, bias=0.0, base=0.0)
