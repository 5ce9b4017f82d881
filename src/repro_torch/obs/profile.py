"""Kernel profiling hooks: profiler ranges + launch features from shapes.

The ``profile=`` mode of the device backend does two things per
merge/E-step/Gibbs launch:

* wraps the launch in a ``torch.profiler.record_function`` range (and,
  on a CUDA device, an NVTX range), so a ``torch.profiler.profile()``
  capture attributes device time to the MLego op that caused it, and
* counts the launch's flops and HBM bytes from the shapes of its
  operands (:func:`merge_features`, no compile) and lands them as
  ``kernel_*`` attributes on the ambient span — the same span whose
  measured milliseconds the calibration log consumes, so one trace row
  carries both the prediction features and the label.

The JAX package derives the same features from the launch's compiled
HLO and names them ``hlo_*``; there is no HLO here, so the prefix is
``kernel_``.  The counts are those of the least-time bound
``chip_smoke.py`` states for the merge kernel: each input read once, the
output written once.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Union

import torch

from repro_torch.obs import trace as _trace

__all__ = ["annotate", "annotate_span", "merge_features"]


@contextmanager
def annotate(name: str,
             device: Union[str, torch.device, None] = None) -> Iterator[None]:
    """A ``record_function`` range named ``name``; on a CUDA ``device``
    also an NVTX range (the CPU build of torch has no NVTX)."""
    nvtx = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def merge_features(n: int, k: int, v: int) -> Dict[str, float]:
    """Flops and HBM bytes of one merge launch over ``n`` (K, V) f32
    parts with f32 unit weights into one (K, V) f32 result:
    ``flops``, ``hbm_bytes`` and ``collective_wire_bytes`` (0: one
    device, no collective)."""
    return {"flops": 3.0 * n * k * v,
            "hbm_bytes": 4.0 * (n * k * v + n + k * v),
            "collective_wire_bytes": 0.0}


def annotate_span(prefix: str, feats: Optional[Dict[str, float]]) -> None:
    """Land launch features on the ambient span as ``<prefix>_<key>``."""
    if feats:
        _trace.set_attrs(**{"%s_%s" % (prefix, k): v
                            for k, v in feats.items()})
