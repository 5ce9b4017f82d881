"""Arithmetic the per-layer readers share: a kernel's share of its
roofline, the card's idle share and the window's share of the peak."""
from __future__ import annotations

from typing import Optional, Sequence

# the port's kernels, by the names the device trace gives them
KERNELS = {
    "merge": ("merge_parts", "merge_vec4", "merge_scalar"),
    "vb_estep": ("estep_csr_iters", "estep_csr_sstats"),
    "gibbs": ("gibbs_blocked",),
}


def least_s(t, kind: str) -> float:
    """Least time of the window's model operations of ``kind``."""
    return sum(w.least_s() for w in t.work.get(kind, ()))


def roofline(t, kind: str) -> Optional[float]:
    """Least time of the operations of ``kind`` over the device time of
    the kernels that ran them, in %; None without both."""
    if t is None or t.device is None or not t.work.get(kind):
        return None
    secs, launches = t.device.time_of(KERNELS[kind])
    if launches == 0 or secs <= 0:
        return None
    return 100.0 * least_s(t, kind) / secs


def idle_share(t) -> Optional[float]:
    """Share of the traced window in which the card ran nothing, in %."""
    if t is None or t.device is None or t.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.device.busy_s / t.device.window_s)


def mfu(t, kinds: Sequence[str]) -> Optional[float]:
    """Least time of every model operation of ``kinds`` the window
    required, at one H100's published peaks, over the traced window's
    wall time, in %."""
    if t is None or t.device is None or t.device.window_s <= 0:
        return None
    need = sum(least_s(t, k) for k in kinds)
    if need <= 0:
        return None
    return 100.0 * need / t.device.window_s
