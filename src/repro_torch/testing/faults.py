"""Deterministic, seeded fault injection for the execution stack.

Production code calls ``maybe_fail("site.name")`` at named injection
sites (store get/save/load, backend merge/fetch/train, the sharded
merge collective, the serve worker loop).  With no injector installed
the call is a single global read and a ``None`` check — cheap enough
to leave in the hot path permanently.  With an injector installed,
each site draws from its *own* seeded RNG stream, so a given
``(seed, site, call-index)`` triple always produces the same verdict:
chaos runs are exactly reproducible in CI without real hardware
faults, and independent sites do not perturb each other's streams.

Rules name a site (exact, or a prefix — ``backend.merge`` matches
``backend.merge.device`` and ``backend.merge.device_sharded``), a
failure rate, and the error *kind* to raise (``transient``,
``permanent``, ``device_lost``, ``corrupt``, ``io``).  ``after`` skips
the first N calls; ``max_failures`` caps how many times the rule
fires (so a test can inject exactly one crash).

Activation:

- programmatic: ``with injected(FaultRule(...), seed=7): ...`` or
  ``install(FaultInjector(...))`` / ``uninstall()``;
- environment: ``MLEGO_FAULTS="seed=7,backend.merge:0.1:transient,
  store.load:1:corrupt:max=1"`` is parsed once at import and
  installed — the hook CI's chaos leg and the chaos bench use.
"""
from __future__ import annotations

import os
import random
import threading
import zlib
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Union

from repro_torch.core.errors import (CorruptModelError, DeviceLostError,
                               PermanentExecutionError,
                               TransientExecutionError)

_KINDS = ("transient", "permanent", "device_lost", "corrupt", "io")


@dataclass(frozen=True)
class FaultRule:
    """One injection rule.

    ``site`` matches exactly or as a dotted prefix.  ``rate`` is the
    per-call failure probability (1.0 = always).  ``kind`` picks the
    exception type.  ``after`` exempts the first N matching calls;
    ``max_failures`` (None = unlimited) caps total firings.
    """

    site: str
    rate: float = 1.0
    kind: str = "transient"
    after: int = 0
    max_failures: Optional[int] = None

    def __post_init__(self) -> None:
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {self.kind!r}")

    def matches(self, site: str) -> bool:
        return site == self.site or site.startswith(self.site + ".")


def _raise_for(kind: str, site: str) -> None:
    msg = f"injected fault at {site!r}"
    if kind == "transient":
        raise TransientExecutionError(msg)
    if kind == "permanent":
        raise PermanentExecutionError(msg)
    if kind == "device_lost":
        # site is e.g. "backend.merge.device_sharded" — last component
        # names the backend that "lost" its device.
        raise DeviceLostError(msg, backend=site.rsplit(".", 1)[-1])
    if kind == "corrupt":
        raise CorruptModelError(msg)
    if kind == "io":
        raise IOError(msg)
    raise ValueError(f"unknown fault kind {kind!r}")


class FaultInjector:
    """Seeded rule set with per-site RNG streams and counters.

    Per-site streams are seeded ``crc32(site) ^ seed`` so adding a new
    site (or reordering calls across sites) never shifts another
    site's verdict sequence.  ``calls``/``failures`` counters are per
    *site string* and thread-safe; tests read them to assert exactly
    how much chaos a run absorbed.
    """

    def __init__(self, rules: Sequence[FaultRule] = (), *, seed: int = 0):
        self.rules: List[FaultRule] = list(rules)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._rngs: Dict[str, random.Random] = {}
        self.calls: Dict[str, int] = {}
        self.failures: Dict[str, int] = {}
        self._fired: Dict[int, int] = {}  # rule index -> firings

    def _rng(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            rng = random.Random((zlib.crc32(site.encode("utf-8"))
                                 & 0xFFFFFFFF) ^ self.seed)
            self._rngs[site] = rng
        return rng

    def check(self, site: str) -> None:
        """Record a call at ``site``; raise if a rule fires."""
        with self._lock:
            n_prior = self.calls.get(site, 0)
            self.calls[site] = n_prior + 1
            for idx, rule in enumerate(self.rules):
                if not rule.matches(site):
                    continue
                if n_prior < rule.after:
                    continue
                fired = self._fired.get(idx, 0)
                if rule.max_failures is not None \
                        and fired >= rule.max_failures:
                    continue
                # Draw even for rate=1.0 so stream positions stay
                # aligned when a test flips a rule's rate.
                if self._rng(site).random() >= rule.rate:
                    continue
                self._fired[idx] = fired + 1
                self.failures[site] = self.failures.get(site, 0) + 1
                kind = rule.kind
                break
            else:
                return
        _raise_for(kind, site)

    @property
    def total_failures(self) -> int:
        with self._lock:
            return sum(self.failures.values())

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {"calls": dict(self.calls),
                    "failures": dict(self.failures)}


# -- global hook ---------------------------------------------------------

_active: Optional[FaultInjector] = None


def maybe_fail(site: str) -> None:
    """The production-side hook: no-op unless an injector is installed."""
    inj = _active
    if inj is not None:
        inj.check(site)


def active_injector() -> Optional[FaultInjector]:
    return _active


def install(injector: FaultInjector) -> None:
    global _active
    _active = injector


def uninstall() -> None:
    global _active
    _active = None


@contextmanager
def injected(*rules: Union[FaultRule, "FaultInjector"],
             seed: int = 0) -> Iterator[FaultInjector]:
    """Scoped installation: ``with injected(FaultRule(...), seed=7) as inj:``.

    Accepts either rules (an injector is built around them) or a
    single pre-built ``FaultInjector``.  Restores the previous
    injector on exit, so scopes nest.
    """
    if len(rules) == 1 and isinstance(rules[0], FaultInjector):
        inj = rules[0]
    else:
        inj = FaultInjector([r for r in rules
                             if isinstance(r, FaultRule)], seed=seed)
    global _active
    prev = _active
    _active = inj
    try:
        yield inj
    finally:
        _active = prev


# -- environment hook ----------------------------------------------------

def from_env(value: str) -> FaultInjector:
    """Parse ``MLEGO_FAULTS`` syntax into an injector.

    ``"seed=7,backend.merge:0.1:transient,store.load:1:corrupt:max=1"``
    — comma-separated entries; ``seed=N`` anywhere sets the seed; each
    rule is ``site:rate[:kind][:after=N][:max=N]``.
    """
    seed = 0
    rules: List[FaultRule] = []
    for entry in value.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if entry.startswith("seed="):
            seed = int(entry[5:])
            continue
        parts = entry.split(":")
        if len(parts) < 2:
            raise ValueError(f"bad MLEGO_FAULTS entry {entry!r} "
                             "(want site:rate[:kind][:after=N][:max=N])")
        site, rate = parts[0], float(parts[1])
        kind, after, max_failures = "transient", 0, None
        for extra in parts[2:]:
            if extra.startswith("after="):
                after = int(extra[6:])
            elif extra.startswith("max="):
                max_failures = int(extra[4:])
            else:
                kind = extra
        rules.append(FaultRule(site=site, rate=rate, kind=kind,
                               after=after, max_failures=max_failures))
    return FaultInjector(rules, seed=seed)


_env = os.environ.get("MLEGO_FAULTS", "")
if _env:
    install(from_env(_env))


__all__ = ["FaultInjector", "FaultRule", "active_injector", "from_env",
           "injected", "install", "maybe_fail", "uninstall"]
