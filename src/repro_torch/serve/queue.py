"""Coalescing queue — the mechanism that turns concurrent interactive
users into Alg. 4 batches, now with admission control.

Independent analysts submitting within a few milliseconds of each
other would each pay a full plan search + gap training + merge launch.
The paper's batch optimizer exists precisely because those queries
share structure; ``CoalescingQueue.drain`` is where the sharing is
*harvested* at serve time: the worker blocks for one pending query,
then keeps collecting arrivals for a configurable time window (or
until a width cap), and hands the whole bundle back so the service can
fuse compatible specs into one ``submit_many`` call.

The window is a latency/throughput dial: every query waits at most
``window_s`` beyond its own execution time, and in exchange a burst of
n compatible queries rides one joint plan search, trains every shared
gap segment once, and merges in size-bucketed batched launches.
``window_s=0`` degenerates to FIFO serial service (drain returns
whatever is already queued, never waits for more).

Admission control (the production-hardening layer):

  * ``max_queue`` bounds the number of pending queries.  A ``put``
    into a full queue either **displaces** the youngest strictly-
    lower-priority pending query (its future fails with ``ShedError``)
    or, when nothing pending is lower priority, raises ``ShedError``
    at the submitter — the front door rejects instead of queueing
    unboundedly.
  * Items carry ``SubmitOptions`` (deadline, priority, max queue
    wait).  The queue orders drains by priority (FIFO within one
    priority); deadline/queue-wait expiry is enforced by the service
    at execution start, where the clock actually matters.
  * **Mid-queue aging**: an entry that has waited past half its
    ``max_queue_wait_s`` is treated one priority level higher by both
    drain ordering and displacement-victim selection
    (``PendingQuery.effective_priority``) — long-waiting work climbs
    toward the front instead of starving until its overwait shed.
  * ``steal()`` is the work-stealing drain: non-blocking, no
    coalescing window — an idle worker of another pool takes only
    what is already pending so it can never hold foreign work open.

Windowed drains are serialized per queue (one collector at a time):
with several workers on one pool, a burst still coalesces into one
batch instead of being split among concurrently-draining workers —
workers pipeline (one drains the next batch while another executes
the previous) rather than compete.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from repro_torch.api.spec import QuerySpec


class ServiceClosedError(RuntimeError):
    """The service (or its queue) is closed to new queries."""


class ShedError(RuntimeError):
    """Rejected by admission control: the bounded queue was full, the
    query was displaced by a higher-priority arrival, or it waited in
    the queue past its ``max_queue_wait_s``."""


class DeadlineExceededError(RuntimeError):
    """The query's ``deadline_s`` elapsed before execution started."""


@dataclass(frozen=True)
class SubmitOptions:
    """Typed admission options for one submitted query.

    deadline_s       : answer-by budget measured from enqueue; a query
                       whose deadline passes before its group starts
                       executing fails with ``DeadlineExceededError``
                       (work it can no longer use is never done)
    priority         : higher drains first; under a full bounded queue
                       a higher-priority arrival displaces the
                       youngest strictly-lower-priority pending query
    max_queue_wait_s : cap on time spent *queued* (deadline minus
                       execution): exceeded ⇒ ``ShedError`` — the
                       load-shedding knob for open-loop traffic
    """

    deadline_s: Optional[float] = None
    priority: int = 0
    max_queue_wait_s: Optional[float] = None

    def __post_init__(self) -> None:
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be > 0, got {self.deadline_s}")
        if self.max_queue_wait_s is not None and self.max_queue_wait_s < 0:
            raise ValueError(f"max_queue_wait_s must be >= 0, got "
                             f"{self.max_queue_wait_s}")


@dataclass
class PendingQuery:
    """One enqueued spec awaiting execution.

    ``trace_id``/``root_span_id`` are minted by the service front door
    (``repro_torch.obs.trace``) so the per-query root span survives the
    thread hop: the submitter enqueues, a pool worker executes, and
    everything the worker records parents onto the pre-allocated root.
    """

    spec: QuerySpec
    tenant: str
    options: SubmitOptions = field(default_factory=SubmitOptions)
    future: "Future" = field(default_factory=Future)
    enqueued_at: float = field(default_factory=time.perf_counter)
    seq: int = -1                    # assigned by the queue (FIFO tiebreak)
    trace_id: Optional[str] = None
    root_span_id: Optional[str] = None
    # the backend an open breaker moved this query off (its answer's
    # ``fallback_from``)
    rerouted_from: Optional[str] = None

    @property
    def deadline_at(self) -> Optional[float]:
        if self.options.deadline_s is None:
            return None
        return self.enqueued_at + self.options.deadline_s

    def expired(self, now: float) -> bool:
        d = self.deadline_at
        return d is not None and now > d

    def overwaited(self, now: float) -> bool:
        w = self.options.max_queue_wait_s
        return w is not None and (now - self.enqueued_at) > w

    def effective_priority(self, now: float) -> int:
        """Mid-queue aging: an entry that has waited past *half* its
        ``max_queue_wait_s`` gets a one-level priority bump — drain
        order and displacement both see the aged value, so a query
        about to shed on overwait outranks a fresh arrival of its
        nominal priority instead of starving behind it.  Entries
        without a wait cap never age (they cannot overwait-shed)."""
        w = self.options.max_queue_wait_s
        if w is not None and (now - self.enqueued_at) > 0.5 * w:
            return self.options.priority + 1
        return self.options.priority


def _shed_future(future: "Future", exc: Exception) -> None:
    """Fail a still-pending future, tolerating a racing client cancel
    (an already-cancelled future simply stays cancelled)."""
    try:
        future.set_exception(exc)
    except Exception:
        pass


class CoalescingQueue:
    """Thread-safe priority queue with windowed batch drains.

    window_s  : how long a drain keeps collecting after its first item
                (0 = take only what is already queued)
    max_width : hard cap on one drain's size — bounds both the fused
                batch's device footprint and the worst-case head-of-
                line wait a giant burst can impose
    max_queue : bound on pending items (None = unbounded, the pre-
                hardening behavior); see module docstring for the
                full-queue displacement/rejection rule
    on_shed   : callback invoked with each *displaced* item after its
                future has been failed (the service counts sheds per
                tenant through this)
    """

    def __init__(self, window_s: float = 0.005, max_width: int = 16,
                 max_queue: Optional[int] = None,
                 on_shed: Optional[Callable[[PendingQuery], None]] = None):
        if window_s < 0:
            raise ValueError(f"window_s must be >= 0, got {window_s}")
        if max_width < 1:
            raise ValueError(f"max_width must be >= 1, got {max_width}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.window_s = window_s
        self.max_width = max_width
        self.max_queue = max_queue
        self.on_shed = on_shed
        self.shed = 0                       # displaced-item count
        self._items: List[PendingQuery] = []
        self._cond = threading.Condition()
        # one windowed collector at a time (see module docstring)
        self._drain_lock = threading.Lock()
        self._seq = 0
        self._closed = False

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Refuse new work; queued items remain drainable.  Atomic
        against ``put`` (same lock), so callers may safely
        drain-then-join after this returns."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def put(self, item: PendingQuery) -> None:
        victim: Optional[PendingQuery] = None
        with self._cond:
            if self._closed:
                raise ServiceClosedError("queue is closed to new queries")
            if self.max_queue is not None \
                    and len(self._items) >= self.max_queue:
                # displace the *youngest strictly-lower-priority*
                # pending item — late low-priority work yields to an
                # urgent arrival; among equals, first come first served
                # (the arrival is the one rejected)
                # aged entries displace as their *effective* priority —
                # a query nearing its overwait shed is not a valid
                # victim for a merely-equal fresh arrival
                now = time.perf_counter()
                candidates = [
                    it for it in self._items
                    if it.effective_priority(now) < item.options.priority]
                if not candidates:
                    raise ShedError(
                        f"queue full ({self.max_queue} pending) and no "
                        f"lower-priority query to displace")
                victim = min(candidates,
                             key=lambda it: (it.effective_priority(now),
                                             -it.seq))
                self._items.remove(victim)
                self.shed += 1
            item.seq = self._seq
            self._seq += 1
            self._items.append(item)
            self._cond.notify()
        if victim is not None:
            # outside the lock: the future callback / on_shed may run
            # arbitrary client code
            _shed_future(victim.future, ShedError(
                "displaced from a full queue by a higher-priority query"))
            if self.on_shed is not None:
                self.on_shed(victim)

    def _pop_best_locked(self) -> PendingQuery:
        now = time.perf_counter()
        best = min(self._items,
                   key=lambda it: (-it.effective_priority(now), it.seq))
        self._items.remove(best)
        return best

    def drain(self, timeout: float = 0.05) -> List[PendingQuery]:
        """One coalescing round.

        Blocks up to ``timeout`` for a first pending query ([] if none
        arrives — the worker's idle poll), then keeps collecting until
        the window closes or ``max_width`` is reached.  The window is
        anchored at the *first* item's drain, not at each arrival, so
        a steady trickle cannot hold a batch open forever.  Items come
        out priority-first (FIFO within a priority).
        """
        with self._drain_lock:
            end = time.perf_counter() + max(timeout, 0.0)
            with self._cond:
                while not self._items:
                    remaining = end - time.perf_counter()
                    if remaining <= 0 or self._closed:
                        # closed+empty: nothing will ever arrive
                        if not self._items:
                            return []
                        break
                    self._cond.wait(remaining)
                batch = [self._pop_best_locked()]
                wend = time.perf_counter() + self.window_s
                while len(batch) < self.max_width:
                    if self._items:
                        batch.append(self._pop_best_locked())
                        continue
                    remaining = wend - time.perf_counter()
                    if remaining <= 0 or self._closed:
                        break
                    self._cond.wait(remaining)
                return batch

    def steal(self, max_width: Optional[int] = None) -> List[PendingQuery]:
        """Work-stealing drain: non-blocking, windowless — take up to
        ``max_width`` items that are *already* pending.  Returns []
        immediately when another worker is mid-drain (the thief must
        not race the home collector for a coalescing batch)."""
        if not self._drain_lock.acquire(blocking=False):
            return []
        try:
            with self._cond:
                cap = max_width if max_width is not None else self.max_width
                batch: List[PendingQuery] = []
                while self._items and len(batch) < cap:
                    batch.append(self._pop_best_locked())
                return batch
        finally:
            self._drain_lock.release()


__all__ = [
    "CoalescingQueue",
    "DeadlineExceededError",
    "PendingQuery",
    "ServiceClosedError",
    "ShedError",
    "SubmitOptions",
]
