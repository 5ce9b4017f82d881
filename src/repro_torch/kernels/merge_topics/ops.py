"""Public wrappers of the merge kernels (``csrc/merge_topics.cu``).

Source note.  ``merge_topics`` and ``merge_topics_parts`` replace the
Pallas kernel ``merge_topics_pallas`` (``src/repro/kernels/merge_topics/
merge_topics.py:37``), ``merge_topics_batch`` replaces
``merge_topics_batched_pallas`` (same file, :66) and
``merge_topics_parts_segments`` replaces ``merge_topics_ragged_pallas``
(same file, :112).  All are bound by
device memory: the merge reads each of the n (K, V) float32 statistics
once and writes the result once, (n+1)·K·V·4 bytes, for ~2 flops per
element read.  The kernels keep each output element's running sum in a
register, read the inputs with 16-byte loads where K·V allows, and
touch no byte twice.

``merge_topics_parts`` takes the n parts as separate tensors: their
pointers and the weights go to the kernel by value in its parameters
(up to ``MAX_PARAM_PARTS``; a larger n uploads a small pointer table),
so a merge of cached models copies nothing first, and each thread has a
chunk of 8 rows' loads in flight before its first FMA.  ``merge_topics``
keeps its (n, K, V) signature and passes the rows of ``stats``.

``merge_topics_parts_segments`` is the ragged merge by pointer table:
R separate (K, V) tensors grouped into segments of consecutive parts,
one (K, V) result a segment, in one launch of the same ``merge_parts``
kernel.  The part pointers, the weights and the segments' row offsets
go up in one pinned upload (``parts_table``, which a caller may build
ahead of the launch), so a batch of merges over cached models copies no
part; its sums equal the stacked ragged kernel's bit for bit.

Each (segment, output tile) is its own program, looping over the
segment's rows from CSR offsets built on the host: no atomics, one
launch, zero pad rows, the same sum order on every run.
``merge_topics_segments`` runs the same merge over one stacked
(R, K, V) copy; no path calls it, and it stays as the pointer-table
route's parity reference on the card.  The batched form is the stacked
kernel with implicit uniform offsets [0, n, 2n, …] (no offsets array to
copy).  Unlike the TPU wrapper there
is no padding of K to 8 or V to 128; the kernels mask the flat K·V range
themselves.

``merge_topics_bucketed`` is the retired power-of-two-bucket launcher
(``src/repro/kernels/merge_topics/ops.py:130``), kept, as in the JAX
package, only as the parity reference of the ragged path.

A tensor on the CPU goes to the plain version in ``ref.py``; a CUDA
tensor goes to the kernel or raises.  ``merge_topics_launches`` (the
single merge, from either wrapper), ``merge_topics_ragged_launches``
(the ragged merge by pointer table), ``merge_topics_segments_launches``
(the stacked reference) and ``merge_topics_batch_launches`` count
kernel launches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.plan_ir import size_buckets
from repro_torch.kernels import common
from repro_torch.kernels.merge_topics.ref import (
    merge_topics_batched_ref,
    merge_topics_ref,
    merge_topics_segments_ref,
)

MAX_PARAM_PARTS = 128   # parts whose pointers and weights go by value

merge_topics_launches = 0
merge_topics_batch_launches = 0
merge_topics_ragged_launches = 0
merge_topics_segments_launches = 0


def cost(n: int, k: int, v: int) -> common.Cost:
    """One merge of n (K, V) statistics (``merge_topics``, the parts
    form): the statistics and the weights read once, the (K, V) result
    written once; 3 operations per input element (the weighted sum, 2 of
    them a product's, and the bias) at the fp32 peak."""
    return common.Cost(4 * (n * k * v + n + k * v),
                       ((3 * n * k * v, common.PEAK_F32_FLOPS),),
                       2 * n * k * v)


def segments_cost(counts: Sequence[int], k: int, v: int) -> common.Cost:
    """One ragged merge (``merge_topics_parts_segments``, or
    ``merge_topics_segments`` over a stack) of segments of
    ``counts`` statistics: the statistics, weights and offsets read once,
    one (K, V) result per segment written once; 3 operations per input
    element."""
    r, n = sum(counts), len(counts)
    return common.Cost(4 * (r * k * v + r + n + 1 + n * k * v),
                       ((3 * r * k * v, common.PEAK_F32_FLOPS),),
                       2 * r * k * v)


def batch_cost(b: int, n: int, k: int, v: int) -> common.Cost:
    """One batched merge (``merge_topics_batch``) of b merges of n: the
    statistics and weights read once, b results written once; 2
    operations per input element (the gs merge: bias = base = 0)."""
    return common.Cost(4 * (b * n * k * v + b * n + b * k * v),
                       ((2 * b * n * k * v, common.PEAK_F32_FLOPS),),
                       2 * b * n * k * v)


def _check(stats: torch.Tensor, weights: torch.Tensor) -> None:
    if stats.dim() != 3:
        raise ValueError(f"stats must be (n, K, V), got {tuple(stats.shape)}")
    if weights.shape != (stats.shape[0],):
        raise ValueError(f"weights must be ({stats.shape[0]},), got "
                         f"{tuple(weights.shape)}")
    common.same_device(stats=stats, weights=weights)


def merge_topics(stats: torch.Tensor, weights: torch.Tensor,
                 bias: float = 0.0, base: float = 0.0) -> torch.Tensor:
    """stats (n, K, V) f32, weights (n,) f32 -> (K, V) f32."""
    _check(stats, weights)
    if stats.device.type == "cpu":
        return merge_topics_ref(stats, weights, bias, base)
    common.require_cuda("stats", stats, stats.device)
    return merge_topics_parts(stats.unbind(0), weights, bias, base)


def merge_topics_parts(parts: Sequence[torch.Tensor],
                       weights: Union[torch.Tensor, Sequence[float]],
                       bias: float = 0.0, base: float = 0.0) -> torch.Tensor:
    """bias + Σ_r w_r (parts[r] − base) over n separate (K, V) f32
    tensors -> (K, V) f32, with no stacked copy of the parts.

    ``weights`` is a (n,) float32 tensor on the parts' device, or n
    numbers (a sequence or a CPU tensor) that go to the kernel by value.
    """
    parts = list(parts)
    n = len(parts)
    shape, dev = _parts_device(parts)
    on_device = isinstance(weights, torch.Tensor) and \
        weights.device.type != "cpu"
    if on_device:
        common.same_device(parts=parts[0], weights=weights)
        w = weights
    else:
        w = torch.as_tensor(np.asarray(
            weights.numpy() if isinstance(weights, torch.Tensor) else weights,
            np.float32))
    if tuple(w.shape) != (n,):
        raise ValueError(f"weights must be ({n},), got {tuple(w.shape)}")
    if dev.type == "cpu":
        return merge_topics_ref(torch.stack(parts), w, bias, base)
    for i, p in enumerate(parts):
        common.require_cuda(f"parts[{i}]", p, dev)
    if on_device:
        common.require_cuda("weights", w, dev)
    k, v = shape
    ptrs = np.array([p.data_ptr() for p in parts], np.uint64)
    host_w = None if on_device else w.numpy()
    dev_w = w.data_ptr() if on_device else None
    table = None
    if n > MAX_PARAM_PARTS:
        # n pointers (then n weights, if they came from the host) in one
        # small upload; pinned, so the copy is queued on the stream
        blob = ptrs.tobytes() + (b"" if on_device else host_w.tobytes())
        table = torch.frombuffer(bytearray(blob), dtype=torch.uint8) \
            .pin_memory().to(dev, non_blocking=True)
        if not on_device:
            dev_w = table.data_ptr() + 8 * n
    out = torch.empty((k, v), dtype=torch.float32, device=dev)
    common.launch(
        "merge_topics", "mlego_merge_topics_parts", dev,
        ptrs.ctypes.data, None if host_w is None else host_w.ctypes.data,
        table, dev_w, n, k * v,
        float(bias), float(base), out, common.stream_of(out))
    common.count_launch(globals(), "merge_topics_launches")
    return out


def _parts_device(parts: Sequence[torch.Tensor]
                  ) -> Tuple[Tuple[int, int], torch.device]:
    """((K, V), device) of n >= 1 parts of one shape on one device."""
    if not parts:
        raise ValueError("a merge needs at least one part")
    shape = tuple(parts[0].shape)
    if len(shape) != 2 or any(tuple(p.shape) != shape for p in parts):
        raise ValueError(f"parts must all be (K, V), got "
                         f"{sorted({tuple(p.shape) for p in parts})}")
    dev = common.same_device(**{f"parts[{i}]": p for i, p in enumerate(parts)})
    return shape, dev


@dataclass(frozen=True)
class PartsTable:
    """What a segmented merge reads beside its parts.

    ``ptrs`` the R part pointers (host copy), ``counts`` the segments'
    part counts, ``weights`` the R float32 weights, ``blob`` the device
    table: the pointers, the weights and the len(counts) + 1 int32 row
    offsets, in that order (None on the CPU, whose route reads none)."""

    ptrs: np.ndarray
    counts: Tuple[int, ...]
    weights: np.ndarray
    blob: Optional[torch.Tensor]


def parts_table(parts: Sequence[torch.Tensor], counts: Sequence[int],
                weights: Union[Sequence[float], torch.Tensor, None] = None
                ) -> PartsTable:
    """The table ``merge_topics_parts_segments`` reads for ``parts``
    grouped by ``counts`` (unit weights when ``weights`` is None), sent
    to the parts' device in one pinned upload queued on the current
    stream."""
    parts = list(parts)
    counts = tuple(int(c) for c in counts)
    if not counts or min(counts) < 1 or sum(counts) != len(parts):
        raise ValueError(f"counts {list(counts)} must be >= 1 and sum to "
                         f"the {len(parts)} parts")
    _, dev = _parts_device(parts)
    n = len(parts)
    w = np.ones(n, np.float32) if weights is None else np.asarray(
        weights.numpy() if isinstance(weights, torch.Tensor) else weights,
        np.float32)
    if w.shape != (n,):
        raise ValueError(f"weights must be ({n},), got {w.shape}")
    ptrs = np.array([p.data_ptr() for p in parts], np.uint64)
    blob = None
    if dev.type != "cpu":
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        blob = torch.frombuffer(
            bytearray(ptrs.tobytes() + w.tobytes() + offsets.tobytes()),
            dtype=torch.uint8).pin_memory().to(dev, non_blocking=True)
    return PartsTable(ptrs, counts, w, blob)


def merge_topics_parts_segments(
        parts: Sequence[torch.Tensor], counts: Sequence[int],
        weights: Union[Sequence[float], torch.Tensor, None] = None,
        bias: float = 0.0, base: float = 0.0,
        table: Optional[PartsTable] = None) -> torch.Tensor:
    """Segment s of ``counts`` merges its consecutive parts:
    bias + Σ_r w_r (parts[r] − base) -> (len(counts), K, V) f32, in one
    launch with no stacked copy of the parts.

    ``weights``: R numbers (a sequence or a CPU tensor), ones when None;
    or pass ``table``, built by ``parts_table`` from the same parts and
    counts, which carries them."""
    parts = list(parts)
    if table is None:
        table = parts_table(parts, counts, weights)
    elif weights is not None:
        raise ValueError("give the weights or a table, not both")
    elif tuple(int(c) for c in counts) != table.counts or not np.array_equal(
            table.ptrs, [p.data_ptr() for p in parts]):
        raise ValueError("the table was built for other parts or counts")
    (k, v), dev = _parts_device(parts)
    if dev.type == "cpu":
        w, out, r = torch.from_numpy(table.weights), [], 0
        for c in table.counts:
            out.append(merge_topics_ref(torch.stack(parts[r:r + c]),
                                        w[r:r + c], bias, base))
            r += c
        return torch.stack(out)
    for i, p in enumerate(parts):
        common.require_cuda(f"parts[{i}]", p, dev)
    n, segs = len(parts), len(table.counts)
    at = table.blob.data_ptr()
    out = torch.empty((segs, k, v), dtype=torch.float32, device=dev)
    common.launch(
        "merge_topics_parts_segments", "mlego_merge_topics_parts_segments",
        dev, table.ptrs.ctypes.data, at, at + 8 * n, at + 12 * n, n, segs,
        k * v, float(bias), float(base), out, common.stream_of(out))
    common.count_launch(globals(), "merge_topics_ragged_launches")
    return out


def merge_topics_batch(stats: torch.Tensor, weights: torch.Tensor,
                       bias: float = 0.0, base: float = 0.0) -> torch.Tensor:
    """b independent merges in one launch: stats (b, n, K, V) f32,
    weights (b, n) f32 -> (b, K, V) f32.  Ragged batches pad n with
    zero-weight rows before calling."""
    if stats.dim() != 4:
        raise ValueError(f"stats must be (b, n, K, V), got "
                         f"{tuple(stats.shape)}")
    b, n, k, v = stats.shape
    if weights.shape != (b, n):
        raise ValueError(f"weights must be ({b}, {n}), got "
                         f"{tuple(weights.shape)}")
    _check(stats.reshape(b * n, k, v), weights.reshape(b * n))
    if stats.device.type == "cpu":
        return merge_topics_batched_ref(stats, weights, bias, base)
    dev = stats.device
    common.require_cuda("stats", stats, dev)
    common.require_cuda("weights", weights, dev)
    out = torch.empty((b, k, v), dtype=torch.float32, device=dev)
    common.launch(
        "merge_topics_batch", "mlego_merge_topics_batched", dev,
        stats, weights, out, b, n, k * v,
        float(bias), float(base), common.stream_of(stats))
    common.count_launch(globals(), "merge_topics_batch_launches")
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
    common.require_cuda("stats", stats, dev)
    common.require_cuda("weights", weights, dev)
    _, k, v = stats.shape
    # pinned, so the copy is queued on the stream instead of blocking
    # the host until the device has drained earlier work
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                           dtype=torch.int32).pin_memory().to(
                               dev, non_blocking=True)
    out = torch.empty((len(counts), k, v), dtype=torch.float32, device=dev)
    common.launch(
        "merge_topics_ragged", "mlego_merge_topics_ragged", dev,
        stats, weights, offsets, out, len(counts), k * v, float(bias),
        float(base), common.stream_of(stats))
    common.count_launch(globals(), "merge_topics_segments_launches")
    return out


def segment_ids(counts: Sequence[int]) -> torch.Tensor:
    """CSR row->segment map for a ragged batch: (sum(counts),) int32."""
    return torch.from_numpy(
        np.repeat(np.arange(len(counts)), list(counts)).astype(np.int32))


def merge_topics_bucketed(stats_list: Sequence[torch.Tensor],
                          weights_list: Sequence[torch.Tensor],
                          bias: float = 0.0, base: float = 0.0
                          ) -> Tuple[List[torch.Tensor], int, int]:
    """Ragged batch of merges in power-of-two size buckets.

    Plans are grouped by :func:`size_buckets`; within a bucket rows pad
    with zero weight to the bucket's widest plan and merge in one
    :func:`merge_topics_batch` launch; a bucket of one plan uses the
    unbatched merge.  Returns ``(merged, pad_rows, launches)`` with
    ``merged[i]`` the (K, V) result for input i, in input order.
    """
    counts = [int(s.shape[0]) for s in stats_list]
    out: List[torch.Tensor] = [None] * len(counts)
    pad_rows = launches = 0
    for _, idxs in sorted(size_buckets(counts).items()):
        if len(idxs) == 1:
            i = idxs[0]
            out[i] = merge_topics(stats_list[i], weights_list[i],
                                  bias=bias, base=base)
            launches += 1
            continue
        widest = max(counts[i] for i in idxs)
        rows, weights = [], []
        for i in idxs:
            pad = widest - counts[i]
            stack, w = stats_list[i], weights_list[i].to(torch.float32)
            if pad:
                # zero-weight rows: 0·(0 − base) contributes nothing
                stack = torch.cat([stack, stack.new_zeros(
                    (pad,) + tuple(stack.shape[1:]))])
                w = torch.cat([w, w.new_zeros(pad)])
                pad_rows += pad
            rows.append(stack)
            weights.append(w)
        merged = merge_topics_batch(torch.stack(rows), torch.stack(weights),
                                    bias=bias, base=base)
        launches += 1
        for row, i in enumerate(idxs):
            out[i] = merged[row]
    return out, pad_rows, launches


def merge_vb_stats(lams: torch.Tensor, weights: torch.Tensor,
                   eta: float) -> torch.Tensor:
    """Alg. 1: λ* = η + Σ w_i (λ_i − η).  lams: (n, K, V)."""
    return merge_topics(lams, weights, bias=eta, base=eta)


def merge_gs_stats(deltas: torch.Tensor, staleness: torch.Tensor,
                   decay: float) -> torch.Tensor:
    """Alg. 2: N* = Σ decay^{s_i} ΔN_i.  deltas: (n, K, V)."""
    w = (decay ** staleness.to(torch.float32)).to(deltas.device)
    return merge_topics(deltas, w, bias=0.0, base=0.0)
