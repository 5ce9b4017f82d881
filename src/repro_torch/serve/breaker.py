"""Per-backend circuit breaker for the serve worker pools.

Classic three-state machine, error-rate windowed:

- **closed** — traffic flows; every outcome lands in a sliding window
  of the last ``window`` results.  When the window holds at least
  ``min_samples`` outcomes and the failure fraction reaches
  ``failure_threshold`` (or any outcome is a ``DeviceLostError``-class
  hard failure), the breaker *opens*.
- **open** — ``allow()`` answers False (the service reroutes the group
  to the fallback pool instead of shedding) until ``cooldown_s`` has
  elapsed, measured on the injected clock.
- **half-open** — after cooldown, up to ``half_open_probes`` calls are
  admitted as probes.  Any probe failure re-opens (and restarts the
  cooldown); ``half_open_probes`` consecutive successes close the
  breaker and clear the window.

The breaker itself is policy-free about *what* a failure is — the
service records outcomes; ``record_failure(hard=True)`` marks the
device-loss case that must trip immediately regardless of window
state.  ``on_transition(old, new)`` fires after the lock is released
so the owner can mirror state into backend quarantine flags without
deadlock risk.  All methods are thread-safe; ``snapshot()`` returns
the frozen ``BreakerSnapshot`` that ``ServiceReport.breaker`` carries.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, List, Optional, Tuple

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


@dataclass(frozen=True)
class BreakerPolicy:
    """Tuning knobs; defaults suit the serve bench's open-loop traces."""

    window: int = 20              # sliding outcome window (closed state)
    failure_threshold: float = 0.5  # open at >= this failure fraction
    min_samples: int = 5          # ... once the window holds this many
    cooldown_s: float = 1.0       # open -> half-open delay
    half_open_probes: int = 2     # consecutive successes to close

    def __post_init__(self) -> None:
        if self.window < 1 or self.min_samples < 1:
            raise ValueError("window and min_samples must be >= 1")
        if not 0.0 < self.failure_threshold <= 1.0:
            raise ValueError("failure_threshold must be in (0, 1]")
        if self.half_open_probes < 1:
            raise ValueError("half_open_probes must be >= 1")


@dataclass(frozen=True)
class BreakerSnapshot:
    """Point-in-time view for ``ServiceReport.breaker``."""

    state: str = CLOSED
    failures: int = 0             # window failure count (closed state)
    window: int = 0               # window occupancy
    error_rate: float = 0.0
    opens: int = 0                # lifetime open transitions
    reroutes: int = 0             # calls denied while open
    half_open_probes: int = 0     # probes admitted in current half-open
    since_s: float = 0.0          # seconds in current state
    transitions: int = 0          # lifetime state transitions (any edge)


class CircuitBreaker:
    """One breaker per backend identity (see ``MLegoService``)."""

    def __init__(self, policy: Optional[BreakerPolicy] = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[
                     Callable[[str, str], None]] = None):
        self.policy = policy or BreakerPolicy()
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._since = self._clock()
        self._outcomes: Deque[bool] = deque(maxlen=self.policy.window)
        self._probes_inflight = 0
        self._probe_successes = 0
        self._transitions: List[Tuple[str, str]] = []  # pending hook args
        self.opens = 0
        self.reroutes = 0
        self.transitions = 0

    # -- internals (lock held) ------------------------------------------

    def _transition(self, new: str) -> None:
        old = self._state
        if old == new:
            return
        self._state = new
        self._since = self._clock()
        self.transitions += 1
        if new == OPEN:
            self.opens += 1
        if new == HALF_OPEN:
            self._probes_inflight = 0
            self._probe_successes = 0
        if new == CLOSED:
            self._outcomes.clear()
        if self._on_transition is not None:
            self._transitions.append((old, new))

    def _drain_hooks_locked(self) -> List[Tuple[str, str]]:
        pending, self._transitions = self._transitions, []
        return pending

    def _fire(self, pending: List[Tuple[str, str]]) -> None:
        for old, new in pending:
            self._on_transition(old, new)  # type: ignore[misc]

    def _window_failure_rate(self) -> float:
        if not self._outcomes:
            return 0.0
        return sum(1 for ok in self._outcomes if not ok) \
            / len(self._outcomes)

    def _maybe_half_open_locked(self) -> None:
        if self._state == OPEN and \
                self._clock() - self._since >= self.policy.cooldown_s:
            self._transition(HALF_OPEN)

    # -- public API ------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            state = self._state
            pending = self._drain_hooks_locked()
        self._fire(pending)
        return state

    def allow(self) -> bool:
        """May a call proceed on this backend right now?"""
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == CLOSED:
                verdict = True
            elif self._state == HALF_OPEN and \
                    self._probes_inflight < self.policy.half_open_probes:
                self._probes_inflight += 1
                verdict = True
            else:
                self.reroutes += 1
                verdict = False
            pending = self._drain_hooks_locked()
        self._fire(pending)
        return verdict

    def record_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_successes += 1
                if self._probe_successes >= self.policy.half_open_probes:
                    self._transition(CLOSED)
            elif self._state == CLOSED:
                self._outcomes.append(True)
            pending = self._drain_hooks_locked()
        self._fire(pending)

    def record_failure(self, *, hard: bool = False) -> None:
        """``hard=True`` (device loss) trips immediately from any state."""
        with self._lock:
            if hard or self._state == HALF_OPEN:
                self._transition(OPEN)
            elif self._state == CLOSED:
                self._outcomes.append(False)
                if len(self._outcomes) >= self.policy.min_samples and \
                        self._window_failure_rate() \
                        >= self.policy.failure_threshold:
                    self._transition(OPEN)
            pending = self._drain_hooks_locked()
        self._fire(pending)

    def force_open(self) -> None:
        with self._lock:
            self._transition(OPEN)
            pending = self._drain_hooks_locked()
        self._fire(pending)

    def snapshot(self) -> BreakerSnapshot:
        with self._lock:
            self._maybe_half_open_locked()
            snap = BreakerSnapshot(
                state=self._state,
                failures=sum(1 for ok in self._outcomes if not ok),
                window=len(self._outcomes),
                error_rate=self._window_failure_rate(),
                opens=self.opens,
                reroutes=self.reroutes,
                half_open_probes=self._probes_inflight,
                since_s=max(0.0, self._clock() - self._since),
                transitions=self.transitions)
            pending = self._drain_hooks_locked()
        self._fire(pending)
        return snap


__all__ = ["BreakerPolicy", "BreakerSnapshot", "CircuitBreaker",
           "CLOSED", "HALF_OPEN", "OPEN"]
