"""The device's side of a traced window, from ``torch.profiler``.

``DeviceWindow`` records every operation the card ran between
``start`` and ``stop`` (CUDA activity only: recording every host-side
operator of several threads would cost more than the work it watches).
Right after starting it launches one marker kernel and notes the host
clock, so device timestamps map onto ``time.perf_counter`` and an idle
stretch of the card can be matched with what the host was doing (the
program's spans).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

MARKER = "spin_kernel"


@dataclass
class DeviceOp:
    name: str
    t0: float        # host clock (perf_counter seconds)
    dur: float       # seconds


@dataclass
class DeviceTrace:
    ops: List[DeviceOp]
    window_s: float
    t0: float
    t1: float
    busy: List[Tuple[float, float]] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def time_of(self, patterns: Sequence[str]) -> Tuple[float, int]:
        """(seconds, launches) of the operations whose name holds any
        of ``patterns``."""
        secs, n = 0.0, 0
        for op in self.ops:
            if any(p in op.name for p in patterns):
                secs += op.dur
                n += 1
        return secs, n

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for op in self.ops:
            by[op.name] = by.get(op.name, 0.0) + op.dur
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle(self) -> List[Tuple[float, float]]:
        """Stretches of the window in which the card ran nothing."""
        out, cur = [], self.t0
        for a, b in self.busy:
            if a > cur:
                out.append((cur, a))
            cur = max(cur, b)
        if self.t1 > cur:
            out.append((cur, self.t1))
        return out


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _ns(ev, what: str) -> float:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(ev, f"{what}_us")()) * 1e3


class DeviceWindow:
    """Profile the card over one window; a no-op off the card."""

    def __init__(self, device: torch.device, enabled: bool):
        self.on = enabled and torch.device(device).type == "cuda"
        self._prof = None
        self._mark_host = 0.0
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        if self.on:
            torch.cuda.synchronize()
            self._prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self._prof.start()
            self._mark_host = time.perf_counter()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self) -> Optional[DeviceTrace]:
        if self.on:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        if not self.on:
            return None
        self._prof.stop()
        raw = []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            raw.append((ev.name(), _ns(ev, "start"), _ns(ev, "duration")))
        self._prof = None
        marks = [r for r in raw if MARKER in r[0]]
        base = marks[0][1] if marks else min((r[1] for r in raw),
                                             default=0.0)
        ops = [DeviceOp(n, self._mark_host + (s - base) * 1e-9, d * 1e-9)
               for n, s, d in raw if MARKER not in n]
        ops = [o for o in ops if o.t0 >= self.t0 - 1e-3]
        busy = _union([(max(o.t0, self.t0), min(o.t0 + o.dur, self.t1))
                       for o in ops])
        busy = [(a, b) for a, b in busy if b > a]
        return DeviceTrace(ops=ops, window_s=self.t1 - self.t0, t0=self.t0,
                           t1=self.t1, busy=busy)


def idle_by_host_activity(trace: DeviceTrace, spans,
                          n: int = 10) -> List[List]:
    """The card's idle time, summed by the innermost program span open
    on the host at each idle stretch's midpoint ("no span" where none
    was: the client or the harness).  The ``n`` largest."""
    spans = sorted(spans, key=lambda s: s.t0)
    by: Dict[str, float] = {}
    active: list = []
    i = 0
    for a, b in trace.idle():           # in time order
        mid = 0.5 * (a + b)
        while i < len(spans) and spans[i].t0 <= mid:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s.t1 >= mid]
        best = max(active, key=lambda s: s.t0, default=None)
        name = best.name if best is not None else "no span"
        by[name] = by.get(name, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
