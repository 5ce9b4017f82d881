"""Typed failure taxonomy and the shared retry policy.

Every failure the execution stack can surface is either *transient*
(worth retrying: a flaky device, a stale plan, an injected fault) or
*permanent* (retrying cannot help: a corrupt blob, a malformed spec).
The split is encoded in the class hierarchy so call sites state their
policy with one ``except`` clause instead of enumerating error strings:

``ExecutionError``
    root of the taxonomy (a ``RuntimeError``).
``TransientExecutionError``
    retry may succeed.  ``DeviceLostError`` (a device backend stopped
    responding; the *backend* is suspect, not the query) specializes it.
``PermanentExecutionError``
    retry cannot succeed.  ``CorruptModelError`` (a stored blob failed
    its checksum or could not be deserialized) specializes it, and also
    subclasses ``IOError`` so legacy callers of
    ``ModelStore.load(verify=True)`` that catch ``IOError`` keep
    working.

``RetryPolicy`` is the one retry object the whole stack shares: capped
exponential backoff with *deterministic* jitter (hashed from the site
name and attempt index, so replays under fault injection are exactly
reproducible), per-site attempt budgets, and thread-safe per-site retry
counters that services surface in their reports.  Permanent errors are
never retried regardless of budget.
"""
from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple, Type, TypeVar

T = TypeVar("T")


class ExecutionError(RuntimeError):
    """Root of the MLego failure taxonomy."""


class TransientExecutionError(ExecutionError):
    """A failure that a retry (possibly on another backend) may clear."""


class PermanentExecutionError(ExecutionError):
    """A failure no retry can clear; fail fast to the caller."""


class DeviceLostError(TransientExecutionError):
    """A device backend raised from the runtime mid-merge/train.

    Transient from the *query's* point of view (replay on the fallback
    chain usually succeeds) but a strong health signal for the backend
    that raised it: callers quarantine the backend and let the circuit
    breaker's half-open probe re-admit it.
    """

    def __init__(self, message: str, *, backend: Optional[str] = None):
        super().__init__(message)
        self.backend = backend


class CorruptModelError(IOError, PermanentExecutionError):
    """A stored blob failed verification (checksum/deserialization).

    Subclasses ``IOError`` so pre-taxonomy callers of
    ``ModelStore.load(verify=True)`` that catch ``IOError`` still do.
    """

    def __init__(self, message: str, *, model_id: Optional[str] = None,
                 blob: Optional[str] = None):
        super().__init__(message)
        self.model_id = model_id
        self.blob = blob


def _jitter_unit(site: str, attempt: int) -> float:
    """Deterministic uniform-ish value in [0, 1) for (site, attempt)."""
    h = zlib.crc32(f"{site}:{attempt}".encode("utf-8")) & 0xFFFFFFFF
    return h / 4294967296.0


@dataclass
class RetryPolicy:
    """Capped exponential backoff with deterministic jitter.

    ``max_attempts`` counts *total* tries (1 = no retry).  Delay before
    retry ``i`` (the i-th re-try, 1-based) is
    ``min(max_delay_s, base_delay_s * 2**(i-1)) * (1 - jitter * u)``
    where ``u`` is hashed from ``(site, i)`` — reproducible across
    processes, no RNG state.  ``site_attempts`` overrides the budget
    for specific sites (longest matching prefix wins, mirroring the
    fault-injection harness's site matching).

    The policy is shared across threads; ``retries_by_site`` counters
    are guarded by an internal lock and snapshotted via
    ``snapshot()``.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.01
    max_delay_s: float = 0.5
    jitter: float = 0.5
    site_attempts: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        self._lock = threading.Lock()
        self._retries: Dict[str, int] = {}

    # -- budgets ---------------------------------------------------------

    def attempts_for(self, site: str) -> int:
        """Attempt budget for ``site`` (longest matching prefix wins)."""
        best, best_len = self.max_attempts, -1
        for prefix, n in self.site_attempts.items():
            if (site == prefix or site.startswith(prefix + ".")) \
                    and len(prefix) > best_len:
                best, best_len = n, len(prefix)
        return max(1, best)

    def delay_s(self, attempt: int, site: str = "") -> float:
        """Backoff before re-try ``attempt`` (1-based)."""
        base = min(self.max_delay_s,
                   self.base_delay_s * (2.0 ** (attempt - 1)))
        return base * (1.0 - self.jitter * _jitter_unit(site, attempt))

    # -- counters --------------------------------------------------------

    def _note_retry(self, site: str) -> None:
        with self._lock:
            self._retries[site] = self._retries.get(site, 0) + 1

    def snapshot(self) -> Dict[str, int]:
        """Copy of the per-site retry counters (retries, not attempts)."""
        with self._lock:
            return dict(self._retries)

    @property
    def total_retries(self) -> int:
        with self._lock:
            return sum(self._retries.values())

    # -- retry loop ------------------------------------------------------

    def run(self, fn: Callable[[], T], *, site: str,
            sleep: Optional[Callable[[float], None]] = None,
            on_retry: Optional[Callable[[BaseException, int], None]] = None,
            no_retry: Tuple[Type[BaseException], ...] = ()) -> T:
        """Call ``fn`` under this policy.

        Retries anything except ``PermanentExecutionError`` (and the
        extra ``no_retry`` types, checked first — use it when the call
        site has its own recovery for e.g. ``DeviceLostError``).
        ``on_retry(exc, attempt)`` fires before each re-try, after the
        backoff sleep.  ``sleep`` defaults to ``time.sleep``; tests
        pass a stub.

        Each re-try also lands a zero-duration ``retry`` event on the
        ambient trace span (``repro_torch.obs.trace``), so a query's span
        tree shows every attempt with its site and the error that
        forced it; free when no span is active.
        """
        import time as _time

        from repro_torch.obs import trace as _obs

        do_sleep = sleep if sleep is not None else _time.sleep
        budget = self.attempts_for(site)
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except no_retry:
                raise
            except PermanentExecutionError:
                raise
            except Exception as exc:
                if attempt >= budget:
                    raise
                delay = self.delay_s(attempt, site)
                if delay > 0.0:
                    do_sleep(delay)
                self._note_retry(site)
                _obs.instant("retry", site=site, attempt=attempt,
                             error=type(exc).__name__)
                if on_retry is not None:
                    on_retry(exc, attempt)


__all__ = [
    "CorruptModelError",
    "DeviceLostError",
    "ExecutionError",
    "PermanentExecutionError",
    "RetryPolicy",
    "TransientExecutionError",
]
