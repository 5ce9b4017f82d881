"""Plan cost providers + score function (paper §IV.B–C, §V.B.2).

  sc(p) = α · l_p(p) + (1 − α) · c_t(p)                      (Eq. 2)

  l_p  = 1 − P(x)  — monotone performance-loss in the number of merged
         components x (P(0) = 1, i.e. a single-model plan loses nothing)
  c_t  = c_train(uncovered tokens) + t_m · x
         c_train(N) = κ · M_i · N^e · K  (paper states e = 2; the
         exponent is a calibratable knob — the planner only requires
         monotonicity)

c_t is normalized by the from-scratch cost of the whole query so both
score terms live in [0, 1] and α weighs comparable quantities.

Pricing is pluggable through the ``CostProvider`` base: the analytic
``CostModel`` is the parity default (exactly the pre-IR behavior), and
``CalibratedCostModel`` re-fits κ/t_m from *measured* session timings
and adds the terms the analytic model is blind to on the device
backend — device-cache hits (a cached model's fetch costs ~0), cache
misses (host→device transfer per part), and padding rows in batched
launches.  Providers price plans through two equivalent entry points:

  ``score_models(models, query, index, alpha, scratch)`` — the
      searcher hot path (bare model tuples, no IR construction)
  ``price_plan(plan_ir, alpha, scratch)`` — the Plan-IR form used by
      the session planner and benchmarks

both funnel into one ``_score_from`` so they can never disagree.

The default P(x) follows the paper's Fig. 3/6 measurement (loss grows
roughly geometrically with merge count) and can be re-fit from the
``benchmarks/merging_effect`` run via ``PerformanceLoss.fit``.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.plan_ir import Plan
from repro_torch.core.plans import Interval, subtract


@dataclass(frozen=True)
class PerformanceLoss:
    """Monotone P(x): P(0) = 1, decreasing in merge count x."""

    rho: float = 0.98      # per-merge retention

    def p(self, x: int) -> float:
        return self.rho ** max(x, 0)

    def loss(self, x: int) -> float:
        return 1.0 - self.p(x)

    @classmethod
    def fit(cls, xs: Sequence[int], losses: Sequence[float]) -> "PerformanceLoss":
        """Least-squares fit of rho from measured (x, l_p) pairs."""
        xs = np.asarray(xs, float)
        ls = np.clip(np.asarray(losses, float), 0.0, 0.999)
        mask = xs > 0
        if not mask.any():
            return cls()
        # 1 - rho^x = l  =>  x*log(rho) = log(1-l)
        rho = float(np.exp((np.log(1.0 - ls[mask]) / xs[mask]).mean()))
        return cls(rho=min(max(rho, 1e-3), 0.9999))


class CostProvider:
    """What the plan searchers and the batch optimizer require.

    Concrete providers supply the primitives (``c_train``, ``t_merge``,
    ``ploss``); everything plan-level derives from them here, so the
    analytic and calibrated providers share one scoring skeleton.

    ``version`` changes whenever the provider's prices change (the
    calibrated model bumps it on every refit) — the session plan cache
    keys on it so stale plans are never served at new prices.
    """

    ploss: PerformanceLoss
    t_merge: float
    version: int = 0

    # --- primitives (provider-specific) ----------------------------------
    def c_train(self, n_tokens: float) -> float:
        raise NotImplementedError

    def c_merge(self, x: int) -> float:
        return self.t_merge * max(x, 0)

    # --- plan-level (shared) ----------------------------------------------
    def components(self, n_models: int, uncovered_tokens: float) -> int:
        """#things merged = models + (1 if a fresh model is trained)."""
        return n_models + (1 if uncovered_tokens > 0 else 0)

    def merges(self, n_models: int, uncovered_tokens: float) -> int:
        return max(self.components(n_models, uncovered_tokens) - 1, 0)

    def plan_lp(self, n_models: int, uncovered_tokens: float) -> float:
        return self.ploss.loss(self.merges(n_models, uncovered_tokens))

    def plan_ct(self, uncovered_tokens: float, n_models: int,
                scratch_tokens: float,
                model_ids: Tuple[int, ...] = ()) -> float:
        """Normalized time cost in [0, ~1]."""
        x = self.merges(n_models, uncovered_tokens)
        raw = (self.c_train(uncovered_tokens) + self.c_merge(x)
               + self.fetch_cost(model_ids, uncovered_tokens))
        denom = max(self.c_train(scratch_tokens), 1e-30)
        return raw / denom

    def fetch_cost(self, model_ids: Tuple[int, ...],
                   uncovered_tokens: float) -> float:
        """Backend data-movement cost of bringing the parts to the
        merge — 0 for the analytic model (host merges read Θ in place);
        the calibrated provider prices cache hits vs transfers here."""
        return 0.0

    def _score_from(self, alpha: float, n_models: int,
                    uncovered_tokens: float, scratch_tokens: float,
                    model_ids: Tuple[int, ...] = ()) -> float:
        lp = self.plan_lp(n_models, uncovered_tokens)
        ct = self.plan_ct(uncovered_tokens, n_models, scratch_tokens,
                          model_ids)
        return alpha * lp + (1.0 - alpha) * ct

    def score(self, alpha: float, n_models: int, uncovered_tokens: float,
              scratch_tokens: float) -> float:
        """Aggregate form (no model identity — analytic-equivalent)."""
        return self._score_from(alpha, n_models, uncovered_tokens,
                                scratch_tokens)

    def score_models(self, models: Tuple, query: Interval, index,
                     alpha: float, scratch_tokens: float) -> float:
        """Searcher hot path: price a candidate model set directly."""
        n, unc = plan_stats(models, query, index)
        ids = tuple(m.model_id for m in models)
        return self._score_from(alpha, n, unc, scratch_tokens, ids)

    def price_plan(self, plan: Plan, alpha: float,
                   scratch_tokens: float) -> float:
        """Plan-IR form: price a lowered ``Plan`` (same number as
        ``score_models`` on the model set it was lowered from)."""
        return self._score_from(alpha, plan.n_models,
                                plan.uncovered_tokens, scratch_tokens,
                                plan.model_ids)

    # --- Theorem 3/4 critical point x* ----------------------------------
    def critical_x(self, min_model_tokens: float) -> float:
        """x* = c_t(min model) / t_m — below this width, merge cost is
        negligible and the merge list can be dropped (PSOA++)."""
        return self.c_train(min_model_tokens) / max(self.t_merge, 1e-30)

    # --- speculation payoff (repro_torch.ingest.speculate) ----------------------
    def predict_train_seconds(self, n_tokens: float) -> float:
        """Wall-seconds forecast for training a gap of ``n_tokens`` on
        the backend last named via ``set_train_backend`` — ``c_train``
        is already in raw seconds, so the forecast is the price."""
        return self.c_train(n_tokens)

    def speculation_pays(self, n_tokens: float, next_arrival_s: float,
                         margin: float = 1.0) -> bool:
        """Should a speculative trainer pre-train this gap?

        True when the forecast training time (scaled by ``margin``, a
        safety factor > 1 for conservative speculation) fits inside the
        predicted time until the hot range's next query arrival — i.e.
        the trained capital lands before the query that would repay it.
        Zero-token gaps never pay (nothing to train)."""
        if n_tokens <= 0:
            return False
        return (self.predict_train_seconds(n_tokens) * margin
                <= max(next_arrival_s, 0.0))

    # --- padding (batched device launches, §V.C) --------------------------
    def padding_cost(self, pad_rows: int) -> float:
        """Cost of zero-weight padding rows in a bucketed batch launch
        (0 for the analytic model; calibrated fits it from timings)."""
        return 0.0

    # --- measurement intake (no-ops except on calibrated providers) ------
    def observe_train(self, n_tokens: float, seconds: float,
                      backend: str = "host") -> None:
        pass

    def set_train_backend(self, backend: str) -> None:
        """Name the execution backend whose gap training the next plan
        prices — host and device samplers have different κ (the device
        route runs the blocked Gibbs sweep / fused E-step kernel)."""

    def observe_merge_host(self, n_merges: int, seconds: float) -> None:
        pass

    def observe_merge_device(self, hit_bytes: int, miss_bytes: int,
                             seconds: float,
                             backend: str = "device") -> None:
        """One fused device launch: *bytes* read from the device cache
        (hits) vs transferred host→device (misses).  Per-byte, not
        per-part, so prices stay correct once heterogeneous model
        shapes land.  ``backend`` names which device backend's fit the
        sample feeds — the sharded backend reports per-shard bytes."""

    def observe_pad(self, pad_bytes: int, seconds: float,
                    backend: str = "device") -> None:
        pass


@dataclass(frozen=True)
class CostModel(CostProvider):
    """The paper's analytic model — the parity-default provider."""

    kappa_train: float = 1e-9   # seconds per (M_i · token^e · K) unit
    train_exponent: float = 2.0  # the paper's O(M_i N² K)
    t_merge: float = 1e-4       # seconds per single K×V merge (t_m)
    max_iters: int = 100        # M_i
    n_topics: int = 100         # K
    ploss: PerformanceLoss = field(default_factory=PerformanceLoss)

    def c_train(self, n_tokens: float) -> float:
        return (self.kappa_train * self.max_iters
                * float(n_tokens) ** self.train_exponent * self.n_topics)


# ---------------------------------------------------------------------------
# calibration — fit the provider to measured session timings
# ---------------------------------------------------------------------------

_MAX_OBS = 512    # rolling window per observation kind


@contextlib.contextmanager
def _sidecar_lock(path: str):
    """Advisory exclusive lock serializing sidecar read-merge-replace
    cycles across *processes* (``<path>.lock`` + flock).  Without it a
    concurrent writer pair — e.g. service ``close()`` racing an ingest
    trainer's shutdown save — can both read the same on-disk log and
    the slower replace drops the faster writer's samples.  On platforms
    without ``fcntl`` the lock degrades to best-effort (the atomic
    replace still prevents torn files, only the union guarantee
    weakens)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    f = open(path + ".lock", "a")
    try:
        try:
            import fcntl
            fcntl.flock(f, fcntl.LOCK_EX)
        except ImportError:     # pragma: no cover - non-POSIX fallback
            pass
        yield
    finally:
        try:
            import fcntl
            fcntl.flock(f, fcntl.LOCK_UN)
        except ImportError:     # pragma: no cover
            pass
        f.close()

# JSON sidecar format version; unknown versions load as a cold start
# (never crash a session over a stale sidecar).  2: device_obs/pad_obs
# record *bytes* (hit_bytes, miss_bytes / pad_bytes), not part/row
# counts — format-1 sidecars cold-start rather than mis-scale.
# 3: device_obs/pad_obs are keyed by backend name like train_obs — the
# vocab-sharded backend observes *per-shard* bytes, so mixing its
# samples into the unsharded backend's fit would skew both; format-2
# sidecars cold-start rather than mis-attribute.
CALIBRATION_FORMAT = 3


@dataclass
class Calibration:
    """Rolling measurement log a session accumulates per backend.

    train_obs  : backend name -> (tokens, seconds) per trained gap —
                 κ is fit per backend, so the planner can price host
                 (exact scan) and device (blocked kernel) gap training
                 separately
    host_obs   : (x merges, seconds) per host merge
    device_obs : backend name -> (hit_bytes, miss_bytes, seconds) per
                 fused device launch — bytes read from the device cache
                 vs bytes transferred host→device.  The sharded backend
                 reports *per-shard* bytes (its cache accounts per
                 device), so its per-byte rates are directly comparable
                 to wall time and never pollute the unsharded fit
    pad_obs    : backend name -> (pad_bytes, seconds) per batch launch

    Mutation is serialized by an internal lock: service workers and
    concurrent sessions feed one shared log.
    """

    train_obs: Dict[str, List[Tuple[float, float]]] = field(
        default_factory=dict)
    host_obs: List[Tuple[int, float]] = field(default_factory=list)
    device_obs: Dict[str, List[Tuple[int, int, float]]] = field(
        default_factory=dict)
    pad_obs: Dict[str, List[Tuple[int, float]]] = field(
        default_factory=dict)

    def __post_init__(self):
        self._lock = threading.RLock()

    def _push(self, log: list, sample) -> None:
        with self._lock:
            log.append(sample)
            if len(log) > _MAX_OBS:
                del log[: len(log) - _MAX_OBS]

    def push_train(self, backend: str, sample: Tuple[float, float]) -> None:
        with self._lock:
            self._push(self.train_obs.setdefault(backend, []), sample)

    def push_device(self, backend: str,
                    sample: Tuple[int, int, float]) -> None:
        with self._lock:
            self._push(self.device_obs.setdefault(backend, []), sample)

    def push_pad(self, backend: str, sample: Tuple[int, float]) -> None:
        with self._lock:
            self._push(self.pad_obs.setdefault(backend, []), sample)

    def __len__(self) -> int:
        return (sum(len(o) for o in self.train_obs.values())
                + len(self.host_obs)
                + sum(len(o) for o in self.device_obs.values())
                + sum(len(o) for o in self.pad_obs.values()))

    # --- persistence (the store's JSON sidecar) ---------------------------
    def to_json_dict(self) -> dict:
        with self._lock:
            return {
                "format": CALIBRATION_FORMAT,
                "train_obs": {b: [list(s) for s in obs]
                              for b, obs in self.train_obs.items()},
                "host_obs": [list(s) for s in self.host_obs],
                "device_obs": {b: [list(s) for s in obs]
                               for b, obs in self.device_obs.items()},
                "pad_obs": {b: [list(s) for s in obs]
                            for b, obs in self.pad_obs.items()},
            }

    @classmethod
    def from_json_dict(cls, doc: dict) -> Optional["Calibration"]:
        """None on a version/shape mismatch (callers cold-start)."""
        if not isinstance(doc, dict) \
                or doc.get("format") != CALIBRATION_FORMAT:
            return None
        try:
            return cls(
                train_obs={str(b): [(float(t), float(s)) for t, s in obs]
                           for b, obs in doc["train_obs"].items()},
                host_obs=[(int(x), float(s)) for x, s in doc["host_obs"]],
                device_obs={str(b): [(int(h), int(m), float(s))
                                     for h, m, s in obs]
                            for b, obs in doc["device_obs"].items()},
                pad_obs={str(b): [(int(p), float(s)) for p, s in obs]
                         for b, obs in doc["pad_obs"].items()},
            )
        except (KeyError, TypeError, ValueError, AttributeError):
            return None

    def merged_with(self, other: "Calibration") -> "Calibration":
        """Union of two observation logs, deduplicated by observation
        identity (the sample tuples themselves).  ``other``'s samples
        that this log doesn't already hold are *prepended* — this log
        is the fresher one, so under the rolling window its samples
        survive trimming first."""
        def union(theirs: list, ours: list) -> list:
            have = set(map(tuple, ours))
            out = [s for s in map(tuple, theirs) if s not in have]
            out.extend(map(tuple, ours))
            return out[-_MAX_OBS:]

        def union_keyed(theirs: dict, ours: dict) -> dict:
            return {b: union(theirs.get(b, []), ours.get(b, []))
                    for b in set(theirs) | set(ours)}

        with self._lock:
            merged = Calibration(
                host_obs=union(other.host_obs, self.host_obs),
                device_obs=union_keyed(other.device_obs, self.device_obs),
                pad_obs=union_keyed(other.pad_obs, self.pad_obs),
                train_obs=union_keyed(other.train_obs, self.train_obs),
            )
        return merged

    def save(self, path: str, merge: bool = True) -> None:
        """Atomic write of the JSON sidecar.

        With ``merge`` (the default) the on-disk log is first merged in
        (dedup by observation identity), so two sessions saving to one
        shared sidecar union their logs instead of last-writer-wins
        clobbering.  The whole read-merge-replace runs under an
        advisory file lock (``<path>.lock``), making it a transaction:
        concurrent writer pairs serialize instead of the slower one
        dropping the faster one's samples."""
        with _sidecar_lock(path):
            out = self
            if merge:
                existing = Calibration.load(path)
                if existing is not None:
                    out = self.merged_with(existing)
            d = os.path.dirname(os.path.abspath(path))
            with tempfile.NamedTemporaryFile("w", dir=d, delete=False) as f:
                json.dump(out.to_json_dict(), f, indent=1)
                tmp = f.name
            os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> Optional["Calibration"]:
        """None when missing/unreadable/stale-format (cold start)."""
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        return cls.from_json_dict(doc)

    # Fits are *robust*: jit compilation inflates the first launch /
    # first training call by orders of magnitude, and a mean over raw
    # samples would keep the coefficients (and the provider version
    # the plan cache keys on) churning for many queries.  Medians damp
    # run-to-run jitter, and once three samples exist the single
    # hottest per-unit sample (the compile warm-up) is dropped.
    @staticmethod
    def _robust(unit_rates: Sequence[float]) -> Optional[float]:
        rates = sorted(unit_rates)
        if not rates:
            return None
        if len(rates) >= 3:
            rates = rates[:-1]          # drop the warm-up outlier
        return float(np.median(rates))

    # --- fits -------------------------------------------------------------
    def fit_kappa(self, base: CostModel,
                  backend: str = "host") -> Optional[float]:
        """κ from seconds ≈ κ · M_i · tokens^e · K per trained gap."""
        return self._robust(
            [(s / (base.max_iters * t ** base.train_exponent
                   * base.n_topics))
             for t, s in self.train_obs.get(backend, ())
             if t > 0 and s > 0])

    def fit_kappas(self, base: CostModel) -> Dict[str, float]:
        """Backend name -> fitted κ, for every backend with samples."""
        out = {}
        for backend in self.train_obs:
            kappa = self.fit_kappa(base, backend)
            if kappa is not None:
                out[backend] = kappa
        return out

    def fit_t_merge(self) -> Optional[float]:
        return self._robust(
            [s / x for x, s in self.host_obs if x > 0 and s > 0])

    def fit_device(self, backend: str = "device"
                   ) -> Optional[Tuple[float, float, float]]:
        """(t_launch, t_hit, t_miss): seconds ≈ t_launch
        + t_hit·hit_bytes + t_miss·miss_bytes, nonnegative least
        squares over one backend's log.  t_hit/t_miss are **per byte**
        (per-*shard* byte for the vocab-sharded backend)."""
        obs = [(h, m, s)
               for h, m, s in self.device_obs.get(backend, ()) if s > 0]
        if not obs:
            return None
        if len(obs) >= 3:
            # drop the hottest per-byte launch (jit compile warm-up)
            obs.remove(max(obs, key=lambda o: o[2] / max(o[0] + o[1], 1)))
        a = np.array([[1.0, h, m] for h, m, _ in obs])
        y = np.array([s for _, _, s in obs])
        if len(obs) < 3 or np.linalg.matrix_rank(a) < 3:
            # under-determined: attribute the median per-byte launch
            # cost to the bytes actually moved/read, keeping hit < miss
            t_byte = float(np.median(y / np.maximum(a[:, 1] + a[:, 2], 1)))
            return 0.0, 0.25 * t_byte, t_byte
        sol, *_ = np.linalg.lstsq(a, y, rcond=None)
        return tuple(float(max(v, 0.0)) for v in sol)

    def fit_devices(self) -> Dict[str, Tuple[float, float, float]]:
        """Backend name -> device fit, for every backend with samples."""
        out = {}
        for backend in self.device_obs:
            fit = self.fit_device(backend)
            if fit is not None:
                out[backend] = fit
        return out

    def fit_t_pad(self, backend: str = "device") -> Optional[float]:
        """Per padding *byte* in one backend's batch launches."""
        return self._robust(
            [s / p for p, s in self.pad_obs.get(backend, ())
             if p > 0 and s > 0])

    def fit_t_pads(self) -> Dict[str, float]:
        """Backend name -> fitted t_pad, for every backend with samples."""
        out = {}
        for backend in self.pad_obs:
            t_pad = self.fit_t_pad(backend)
            if t_pad is not None:
                out[backend] = t_pad
        return out


class CalibratedCostModel(CostProvider):
    """Backend-aware provider fitted from measured report timings.

    Starts at exact parity with ``base`` (no observations → analytic
    prices) and tightens as the session feeds it measurements:

      κ (per backend) training cost per token^e, fit separately per
                    execution backend (host exact Gibbs scan vs the
                    blocked device sweep have very different rates);
                    ``set_train_backend`` names the backend whose κ
                    the next plan search prices — **per calling
                    thread** (thread-local), so concurrent sessions,
                    service workers and the speculator can each hold
                    "set, then price" atomic on one shared provider
      t_merge       per-merge host cost
      t_hit/t_miss  per-**byte** device fetch cost split by cache
                    state — ``cache_probe(model_id)`` (wired to the
                    device backend's LRU by the session) decides which
                    applies; ``size_probe(model_id)`` supplies each
                    part's byte size (wired to the store), falling
                    back to ``part_bytes_hint`` so prices stay correct
                    once heterogeneous model shapes land
      t_pad         per padding **byte** in bucketed batch launches

    ``version`` increments on every refit so the session plan cache
    drops plans priced under stale coefficients.  ``calibration`` can
    be preloaded from the store's JSON sidecar (``Calibration.load``)
    so a new session starts at the previous session's prices instead
    of the analytic cold start.  Observation intake and refits are
    lock-serialized, so one provider can be shared by every session
    of a multi-tenant service.
    """

    def __init__(self, base: Optional[CostModel] = None, *,
                 cache_probe: Optional[Callable[[int], bool]] = None,
                 size_probe: Optional[Callable[[int], Optional[int]]] = None,
                 part_bytes_hint: Optional[float] = None,
                 calibration: Optional[Calibration] = None):
        self.base = base or CostModel()
        self.calibration = calibration if calibration is not None \
            else Calibration()
        self.cache_probe = cache_probe
        self.size_probe = size_probe
        self.part_bytes_hint = part_bytes_hint
        # backend name -> device count its cached models are sliced
        # across (sessions populate it).  Sharded backends observe
        # per-shard bytes, so their fetch prices must scale part sizes
        # down by the same factor to stay in the fitted unit.
        self.backend_shards: Dict[str, int] = {}
        # thread-local: one provider is shared by every worker, tenant
        # thread and the speculator of a service, and "set the backend,
        # then price" must be atomic per caller — a plain attribute let
        # a concurrent session's set_train_backend retarget κ between a
        # speculator's set and its speculation_pays read (mis-priced
        # speculative trains)
        self._train_backend = threading.local()
        self._lock = threading.RLock()
        self._version = 0
        self._dirty = len(self.calibration) > 0
        self._kappa: Dict[str, float] = {}
        self._t_merge: Optional[float] = None
        # per-backend device fits: backend name -> (t_hit, t_miss) /
        # t_pad.  Price reads resolve the calling thread's active
        # backend, falling back to the plain "device" fit (same shape
        # as κ's host fallback).
        self._t_fetch: Dict[str, Tuple[float, float]] = {}
        self._t_pads: Dict[str, float] = {}

    # Observations only mark the fit dirty; the (sort + median + lstsq)
    # refit runs at most once per price read, not once per observe_*
    # call on the submit hot path.
    def _ensure_fit(self) -> None:
        with self._lock:
            if self._dirty:
                self._dirty = False
                self.refit()

    @property
    def version(self) -> int:
        """Refit counter; the serve metrics registry mirrors it as
        ``mlego_calibration_refits_total``."""
        self._ensure_fit()
        return self._version

    # --- primitives --------------------------------------------------------
    @property
    def ploss(self) -> PerformanceLoss:
        return self.base.ploss

    @property
    def t_merge(self) -> float:
        with self._lock:
            self._ensure_fit()
            return self._t_merge if self._t_merge is not None \
                else self.base.t_merge

    @property
    def train_backend(self) -> str:
        """The *calling thread's* active training backend ("host" until
        that thread names one) — see ``set_train_backend``."""
        return getattr(self._train_backend, "name", "host")

    @train_backend.setter
    def train_backend(self, backend: str) -> None:
        self._train_backend.name = backend

    def set_train_backend(self, backend: str) -> None:
        self._train_backend.name = backend

    def load_calibration(self, path: str) -> bool:
        """Replace the measurement log with a persisted sidecar's.
        False (and no change) when missing/unreadable/stale-format.

        A sidecar that *exists* but cannot be parsed (corrupt or
        truncated JSON, wrong format version) cold-starts the provider
        at analytic prices with a warning — a damaged price log must
        never fail session construction, it only costs a re-warmup.
        A missing file stays silent: that is the normal first run.
        """
        cal = Calibration.load(path)
        if cal is None:
            if os.path.exists(path):
                warnings.warn(
                    f"calibration sidecar {path!r} is unreadable or "
                    f"stale-format; cold-starting at analytic prices "
                    f"(the log rebuilds from this session's timings)",
                    RuntimeWarning, stacklevel=2)
            return False
        self.calibration = cal
        self._dirty = len(cal) > 0
        return True

    def c_train(self, n_tokens: float) -> float:
        # the active backend's fitted κ; an unfit device backend falls
        # back to the host fit (closer than the analytic prior), then
        # to the analytic base.  Coefficients are snapshotted under the
        # lock so a concurrent refit can't tear the read.
        with self._lock:
            self._ensure_fit()
            kappa = self._kappa.get(self.train_backend,
                                    self._kappa.get("host",
                                                    self.base.kappa_train))
        return (kappa * self.base.max_iters
                * float(n_tokens) ** self.base.train_exponent
                * self.base.n_topics)

    def _fetch_params_locked(self) -> Tuple[float, float]:
        """(t_hit, t_miss) for the calling thread's active backend;
        callers hold ``self._lock``."""
        fit = self._t_fetch.get(self.train_backend,
                                self._t_fetch.get("device"))
        return fit if fit is not None else (0.0, 0.0)

    @property
    def _t_hit(self) -> float:
        with self._lock:
            self._ensure_fit()
            return self._fetch_params_locked()[0]

    @property
    def _t_miss(self) -> float:
        with self._lock:
            self._ensure_fit()
            return self._fetch_params_locked()[1]

    @property
    def _t_pad(self) -> Optional[float]:
        with self._lock:
            self._ensure_fit()
            return self._t_pads.get(self.train_backend,
                                    self._t_pads.get("device"))

    def _part_bytes(self, model_id: Optional[int] = None) -> float:
        """Byte size of one merge part: the store-wired probe when it
        answers, else the session's hint, else 1.0 (which degrades
        per-byte pricing to the old per-part pricing — relative plan
        ordering survives even unwired)."""
        if model_id is not None and self.size_probe is not None:
            nbytes = self.size_probe(model_id)
            if nbytes is not None:
                return float(nbytes)
        return float(self.part_bytes_hint) if self.part_bytes_hint else 1.0

    def fetch_cost(self, model_ids: Tuple[int, ...],
                   uncovered_tokens: float) -> float:
        with self._lock:                     # consistent (t_hit, t_miss)
            self._ensure_fit()
            t_hit, t_miss = self._fetch_params_locked()
        if t_hit == t_miss == 0.0:
            return 0.0
        cost = 0.0
        for mid in model_ids:
            hit = self.cache_probe is not None and self.cache_probe(mid)
            cost += (t_hit if hit else t_miss) * self._part_bytes(mid)
        if uncovered_tokens > 0:
            # the fresh gap model always uploads (hint-sized: it does
            # not exist yet, so no probe can size it)
            cost += t_miss * self._part_bytes()
        # per-shard unit: a sharded backend's fit is seconds per
        # per-device byte, so scale the (global) part sizes down to
        # what any one device actually moves
        return cost / max(self.backend_shards.get(self.train_backend, 1), 1)

    def padding_cost(self, pad_rows: int) -> float:
        """Padding rows share the merge statistic's shape, so one row
        is one (hint-sized) part's worth of bytes."""
        with self._lock:
            self._ensure_fit()
            t_pad = self._t_pads.get(self.train_backend,
                                     self._t_pads.get("device"))
        return (t_pad or 0.0) * max(pad_rows, 0) * self._part_bytes()

    # --- measurement intake -------------------------------------------------
    def observe_train(self, n_tokens: float, seconds: float,
                      backend: str = "host") -> None:
        self.calibration.push_train(backend,
                                    (float(n_tokens), float(seconds)))
        self._dirty = True

    def observe_merge_host(self, n_merges: int, seconds: float) -> None:
        self.calibration._push(self.calibration.host_obs,
                               (int(n_merges), float(seconds)))
        self._dirty = True

    def observe_merge_device(self, hit_bytes: int, miss_bytes: int,
                             seconds: float,
                             backend: str = "device") -> None:
        self.calibration.push_device(backend,
                                     (int(hit_bytes), int(miss_bytes),
                                      float(seconds)))
        self._dirty = True

    def observe_pad(self, pad_bytes: int, seconds: float,
                    backend: str = "device") -> None:
        """``seconds`` must be the *marginal* time attributable to the
        padding bytes (callers apportion the launch wall time), not
        the whole launch — t_pad multiplies per byte."""
        self.calibration.push_pad(backend, (int(pad_bytes), float(seconds)))
        self._dirty = True

    # Prices within 25% of each other rarely flip a plan choice (the
    # score gaps the searchers discriminate are coarser), but run-to-run
    # kernel timing jitter easily exceeds 5% — a tight threshold would
    # invalidate the plan cache on every submit for nothing.
    @staticmethod
    def _materially_different(a, b, rel: float = 0.25) -> bool:
        for x, y in zip(a, b):
            if (x is None) != (y is None):
                return True
            if x is None:
                continue
            if abs(x - y) > rel * max(abs(x), abs(y), 1e-30):
                return True
        return False

    def refit(self) -> None:
        with self._lock:
            c = self.calibration
            kappas = c.fit_kappas(self.base)
            t_merge = c.fit_t_merge()
            fetch = {b: (hit, miss)
                     for b, (_, hit, miss) in c.fit_devices().items()}
            if t_merge is None and fetch:
                # device sessions never see a host merge; the launch
                # cost amortized over one part's bytes is the closest
                # t_m analogue (taken from the cheapest fitted backend)
                t_hit = min(hit for hit, _ in fetch.values())
                t_merge = max(t_hit * self._part_bytes(),
                              self.base.t_merge)
            pads = c.fit_t_pads()
            for b, (hit, _) in fetch.items():
                # padding bytes stream like cached bytes of bandwidth;
                # the ragged launcher never pads so most backends only
                # ever see this default
                pads.setdefault(b, hit)
            kb = sorted(set(kappas) | set(self._kappa))
            fb = sorted(set(fetch) | set(self._t_fetch))
            pb = sorted(set(pads) | set(self._t_pads))

            def flat(ka, fe, pa, tm):
                out = tuple(ka.get(b) for b in kb) + (tm,)
                for b in fb:
                    out += fe.get(b, (None, None))
                return out + tuple(pa.get(b) for b in pb)

            new = flat(kappas, fetch, pads, t_merge)
            old = flat(self._kappa, self._t_fetch, self._t_pads,
                       self._t_merge)
            self._kappa, self._t_merge = kappas, t_merge
            self._t_fetch, self._t_pads = fetch, pads
            # version gates the session plan cache: bump only when
            # prices moved materially, so a converged calibration keeps
            # repeated queries on the cached plan
            if self._materially_different(new, old):
                self._version += 1


def plan_stats(plan: Tuple, query: Interval, index) -> Tuple[int, float]:
    """(n_models, uncovered_tokens) for a model set against a DataIndex."""
    gaps = subtract(query, [m.o for m in plan])
    unc = float(sum(index.tokens_in(g.lo, g.hi) for g in gaps))
    return len(plan), unc
