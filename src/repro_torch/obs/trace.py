"""Zero-dependency tracing core: spans, tracers, Chrome-trace export.

One query through the serve stack crosses four subsystems (queue,
session, executor, backend) and at least two threads (the submitting
caller and the pool worker that drains it).  The ad-hoc counters that
grew up around those layers can say *how much* time the system spent
merging, but not *where this one query's 40 ms went*.  This module is
the answer: a `Span` is one timed region with an explicit parent, a
`Tracer` is a thread-safe ring buffer of finished spans, and
`Tracer.to_chrome()` serializes the buffer as Chrome trace-event JSON
that loads directly in Perfetto (or ``chrome://tracing``).

Design rules, in priority order:

* **Zero dependencies.**  Stdlib only.  The tracer must be importable
  from `core/errors.py` without creating a cycle, so this module
  imports nothing from ``repro``.
* **Cheap when idle.**  Code that *might* run under a trace (backends,
  the retry loop, kernel wrappers) calls the module-level `span()` /
  `instant()` / `set_attrs()` helpers, which consult a thread-local
  context stack: when no enclosing span is active they are a dict
  lookup and a ``None`` check.  Only span *owners* (session, service)
  hold a `Tracer` reference.
* **Monotonic clocks.**  All timestamps are ``time.perf_counter()``
  seconds.  Chrome export rebases them onto the tracer's own epoch so
  traces from one process line up; never mix wall-clock in.
* **Explicit parents, implicit nesting.**  Entering ``tracer.span()``
  pushes the span onto the calling thread's context stack, so nested
  spans pick up their parent automatically.  Crossing a thread (a
  pool worker finishing a query enqueued elsewhere) passes
  ``trace_id=`` / ``parent_id=`` explicitly — the queue item carries
  them.

A ``trace_id`` groups every span recorded on behalf of one logical
query; it is minted by `Tracer.new_trace_id()` at the outermost entry
point (service front door or a direct ``session.submit``) and rides
``QueryReport.trace`` back to the caller, so a slow report can be
looked up in the exported trace by id.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "Span",
    "Tracer",
    "current_span",
    "current_tracer",
    "instant",
    "set_attrs",
    "span",
]


@dataclass
class Span:
    """One timed region.  ``t0``/``t1`` are ``perf_counter`` seconds."""

    name: str
    kind: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    t0: float
    t1: float = 0.0
    thread: int = 0
    attrs: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return max(0.0, self.t1 - self.t0)


class _NullCtx:
    """Reusable no-op context manager for the disabled/ambient-miss path."""

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: object) -> bool:
        return False


_NULL_CTX = _NullCtx()

# Per-thread stack of (tracer, span) for implicit parent inheritance.
_tls = threading.local()


def _stack() -> List[Tuple["Tracer", Span]]:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = []
        _tls.stack = s
    return s


def current_tracer() -> Optional["Tracer"]:
    """The tracer owning the innermost active span on this thread."""
    s = _stack()
    return s[-1][0] if s else None


def current_span() -> Optional[Span]:
    """The innermost active span on this thread (not yet recorded)."""
    s = _stack()
    return s[-1][1] if s else None


def set_attrs(**attrs: Any) -> None:
    """Annotate the innermost active span; no-op without one."""
    sp = current_span()
    if sp is not None:
        sp.attrs.update(attrs)


def span(name: str, cat: str = "internal", **attrs: Any):
    """Open a child span under the ambient context, or no-op without one.

    This is the hook for code that does not own a tracer (backends,
    executor, retry loop, kernel wrappers): if the calling thread is
    inside a ``Tracer.span()`` region the child lands in that tracer;
    otherwise nothing is recorded and the overhead is one ``getattr``.
    ``cat`` becomes the span's ``kind``; remaining keywords become
    attributes (so an attribute may itself be named ``kind``).
    """
    tr = current_tracer()
    if tr is None:
        return _NULL_CTX
    return tr.span(name, cat, attrs=attrs or None)


def instant(name: str, cat: str = "event", **attrs: Any) -> None:
    """Record a zero-duration event under the ambient span, if any."""
    s = _stack()
    if not s:
        return
    tr, parent = s[-1]
    now = tr._clock()
    tr.record(name, cat, now, now, trace_id=parent.trace_id,
              parent_id=parent.span_id, attrs=attrs or None)


class Tracer:
    """Thread-safe span sink with a bounded ring buffer.

    ``capacity`` bounds memory: once full, the oldest spans are
    overwritten and ``dropped`` counts how many were lost (exported
    traces say so).  ``enabled=False`` turns every entry point into a
    no-op that still yields ``None`` — callers guard attribute access
    with ``if sp is not None`` or use `set_attrs()`.
    """

    def __init__(self, capacity: int = 16384, enabled: bool = True,
                 clock=time.perf_counter):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.enabled = enabled
        self.dropped = 0
        self._clock = clock
        self._epoch = clock()
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)

    # -- ids -------------------------------------------------------------

    def new_trace_id(self) -> str:
        return "t%06x" % next(self._ids)

    def new_span_id(self) -> str:
        return "s%06x" % next(self._ids)

    # -- recording -------------------------------------------------------

    @contextmanager
    def span(self, name: str, kind: str = "internal", *,
             trace_id: Optional[str] = None,
             parent_id: Optional[str] = None,
             attrs: Optional[Dict[str, Any]] = None) -> Iterator[Optional[Span]]:
        """Open a span; records on exit (including on exception).

        Parentage: explicit ``trace_id``/``parent_id`` win; otherwise
        both are inherited from the innermost active span on this
        thread; otherwise a fresh trace is minted.
        """
        if not self.enabled:
            yield None
            return
        stack = _stack()
        if trace_id is None:
            if parent_id is None and stack:
                _, top = stack[-1]
                trace_id, parent_id = top.trace_id, top.span_id
            elif parent_id is None:
                trace_id = self.new_trace_id()
            else:
                # explicit parent without a trace: inherit the ambient
                # trace if there is one, else mint.
                trace_id = (stack[-1][1].trace_id if stack
                            else self.new_trace_id())
        sp = Span(name=name, kind=kind, trace_id=trace_id,
                  span_id=self.new_span_id(), parent_id=parent_id,
                  t0=self._clock(), thread=threading.get_ident(),
                  attrs=dict(attrs) if attrs else {})
        stack.append((self, sp))
        try:
            yield sp
        except BaseException as exc:
            sp.attrs.setdefault("error", type(exc).__name__)
            raise
        finally:
            stack.pop()
            sp.t1 = self._clock()
            self._append(sp)

    def record(self, name: str, kind: str, t0: float, t1: float, *,
               trace_id: str, span_id: Optional[str] = None,
               parent_id: Optional[str] = None,
               attrs: Optional[Dict[str, Any]] = None) -> Optional[Span]:
        """Record a span whose lifetime was measured externally.

        Used for regions that start on one thread and end on another
        (queue wait, per-query serve roots): the owner pre-allocates
        ``span_id`` so children recorded in between can parent onto it.
        """
        if not self.enabled:
            return None
        sp = Span(name=name, kind=kind, trace_id=trace_id,
                  span_id=span_id or self.new_span_id(),
                  parent_id=parent_id, t0=t0, t1=t1,
                  thread=threading.get_ident(),
                  attrs=dict(attrs) if attrs else {})
        self._append(sp)
        return sp

    def _append(self, sp: Span) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self.dropped += 1
            self._buf.append(sp)

    # -- reading ---------------------------------------------------------

    def spans(self, trace_id: Optional[str] = None,
              name: Optional[str] = None) -> List[Span]:
        """Snapshot of recorded spans, optionally filtered, in t0 order."""
        with self._lock:
            out = list(self._buf)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        if name is not None:
            out = [s for s in out if s.name == name]
        out.sort(key=lambda s: s.t0)
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dropped = 0

    # -- export ----------------------------------------------------------

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (dict); loads in Perfetto as-is.

        Durations become ``ph: "X"`` complete events, zero-duration
        spans become ``ph: "i"`` instants.  Timestamps are microseconds
        rebased on the tracer's epoch.  Span/trace/parent ids ride in
        ``args`` so the tree can be reconstructed from the file.
        """
        events: List[Dict[str, Any]] = []
        for sp in self.spans():
            us0 = (sp.t0 - self._epoch) * 1e6
            args = {"trace_id": sp.trace_id, "span_id": sp.span_id}
            if sp.parent_id:
                args["parent_id"] = sp.parent_id
            for k, v in sp.attrs.items():
                args[k] = v if isinstance(v, (int, float, bool)) else str(v)
            ev: Dict[str, Any] = {
                "name": sp.name, "cat": sp.kind, "pid": 1,
                "tid": sp.thread, "ts": round(us0, 3), "args": args,
            }
            if sp.t1 > sp.t0:
                ev["ph"] = "X"
                ev["dur"] = round((sp.t1 - sp.t0) * 1e6, 3)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            events.append(ev)
        meta: Dict[str, Any] = {"spans": len(events), "dropped": self.dropped}
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": meta}

    def export_chrome(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.to_chrome(), fh, separators=(",", ":"))
