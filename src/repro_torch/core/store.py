"""Materialized-model store.

Holds ⟨o, N, Θ⟩ tuples, answers "which models are usable for range Q",
persists atomically (npz blobs + json manifest with content hashes) and
participates in the checkpoint manager so a restarted cluster resumes
with its full reuse capital.

Persistence is crash-safe: every blob and the manifest are written
tmp + fsync + rename (a crash mid-save leaves the previous consistent
snapshot), and each blob's sha256 rides in the manifest.  ``load``
verifies checksums; with ``on_corrupt="quarantine"`` a bad or
truncated blob is *skipped* instead of failing the whole load — the
store records it in ``quarantined`` and the planner simply never sees
the model, so Alg. 4 plans around the hole (gap-train or alternate
cover).  ``on_corrupt="raise"`` keeps the legacy fail-fast contract
(the error is a ``CorruptModelError``, an ``IOError`` subclass).

The store is also the lifecycle spine of the streaming-ingestion path
(``repro_torch.ingest``): slice models *append* through ``add``, compaction
*swaps* a run of fine slices for one coarse segment through
``replace`` (atomic under the store lock; listeners see the coarse
"add" before the fine "remove"s, so there is no event ordering in
which the range appears uncovered), and cold capital *evicts* through
``remove``.  All three flow through the one ``subscribe`` channel, so
plan caches and device LRUs invalidate identically for manual saves
and background ingestion.  ``get`` stamps a monotone access clock per
model — ``last_access`` is what the compactor's eviction pass ranks
cold capital by.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.errors import CorruptModelError
from repro_torch.core.lda import MaterializedModel
from repro_torch.core.plans import Interval
from repro_torch.testing.faults import maybe_fail


_BLOB_RE = re.compile(r"model_(-?\d+)\.npz")


@dataclass(frozen=True)
class QuarantinedBlob:
    """One model the store refused to serve (bad checksum, truncated
    blob, or a runtime ``quarantine`` call).  ``o``/``kind`` are kept
    from the manifest so recovery (``distributed.elastic``) knows what
    interval to retrain without re-reading the corrupt file."""

    model_id: int
    file: str
    reason: str
    o: Optional[Interval] = None
    kind: Optional[str] = None


StoreListener = Callable[[str, int], None]


class ModelStore:
    def __init__(self):
        self._models: Dict[int, MaterializedModel] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        self._listeners: List[StoreListener] = []
        # monotone access stamps (model_id -> tick); approximate under
        # concurrency — races only reorder near-simultaneous reads,
        # which is irrelevant for a cold-vs-hot eviction ranking
        self._access: Dict[int, int] = {}
        self._access_clock = 0
        # blobs load() skipped or quarantine() pulled at runtime; the
        # planner never sees these, so plans route around them
        self.quarantined: List[QuarantinedBlob] = []

    # --- change notification -------------------------------------------
    # Execution backends cache device-resident copies of Θ keyed by
    # model id; they subscribe here so mutations invalidate those
    # copies.  Listeners fire outside the lock with (event, model_id),
    # event in {"add", "remove"}.
    def subscribe(self, fn: StoreListener) -> None:
        """Idempotent: a listener is registered at most once, however
        many sessions over this store bind the same shared cache."""
        with self._lock:
            if fn not in self._listeners:
                self._listeners.append(fn)

    def unsubscribe(self, fn: StoreListener) -> None:
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    def _notify(self, event: str, model_id: int) -> None:
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            fn(event, model_id)

    # --- CRUD ---------------------------------------------------------
    def add(self, o: Interval, n_docs: int, n_tokens: int, kind: str,
            theta: Dict[str, np.ndarray]) -> MaterializedModel:
        with self._lock:
            mid = self._next_id
            self._next_id += 1
            m = MaterializedModel(mid, o, n_docs, n_tokens, kind, theta)
            self._models[mid] = m
        self._notify("add", mid)
        return m

    def remove(self, model_id: int) -> None:
        with self._lock:
            existed = self._models.pop(model_id, None) is not None
            self._access.pop(model_id, None)
        if existed:
            self._notify("remove", model_id)

    def replace(self, old_ids: Sequence[int], o: Interval, n_docs: int,
                n_tokens: int, kind: str,
                theta: Dict[str, np.ndarray]) -> MaterializedModel:
        """Compaction primitive: atomically swap ``old_ids`` for one
        coarser model covering their union.

        The insert and the removals commit under one lock acquisition,
        so no concurrent reader ever sees a store missing both the fine
        slices and the coarse segment.  Listeners are notified outside
        the lock, coarse "add" first, then one "remove" per fine slice
        — the same channel (and the same net effect on plan caches and
        device LRUs) as a manual remove-and-retrain.
        """
        old_ids = list(old_ids)
        with self._lock:
            missing = [i for i in old_ids if i not in self._models]
            if missing:
                raise KeyError(f"replace: unknown model ids {missing}")
            mid = self._next_id
            self._next_id += 1
            m = MaterializedModel(mid, o, n_docs, n_tokens, kind, theta)
            self._models[mid] = m
            for i in old_ids:
                self._models.pop(i)
                self._access.pop(i, None)
        self._notify("add", mid)
        for i in old_ids:
            self._notify("remove", i)
        return m

    def get(self, model_id: int) -> MaterializedModel:
        maybe_fail("store.get")
        m = self._models[model_id]
        self._access_clock += 1
        self._access[model_id] = self._access_clock
        return m

    # --- quarantine ------------------------------------------------------
    def quarantine(self, model_id: int, reason: str = "runtime") -> None:
        """Pull a live model from service, remembering what was lost.

        Same invalidation path as ``remove`` (plan caches and device
        LRUs drop it), but the interval/kind land in ``quarantined``
        so ``distributed.elastic.recover_quarantined`` can retrain the
        hole later.
        """
        with self._lock:
            m = self._models.pop(model_id, None)
            self._access.pop(model_id, None)
            if m is not None:
                self.quarantined.append(QuarantinedBlob(
                    model_id=model_id, file=f"model_{model_id}.npz",
                    reason=reason, o=m.o, kind=m.kind))
        if m is not None:
            self._notify("remove", model_id)

    def clear_quarantined(self) -> List[QuarantinedBlob]:
        """Drain the quarantine ledger (after recovery retrained it)."""
        with self._lock:
            drained, self.quarantined = self.quarantined, []
        return drained

    def last_access(self, model_id: int) -> int:
        """Access-clock stamp of the last ``get`` (0 = never fetched) —
        the compactor's cold-capital eviction ranks by this."""
        return self._access.get(model_id, 0)

    def __len__(self) -> int:
        return len(self._models)

    def models(self, kind: Optional[str] = None) -> List[MaterializedModel]:
        # snapshot under the lock: the store is shared by concurrent
        # sessions (the serving layer), and a mid-iteration add/remove
        # must not corrupt a reader's view
        with self._lock:
            ms = list(self._models.values())
        return ms if kind is None else [m for m in ms if m.kind == kind]

    def usable(self, query: Interval, kind: Optional[str] = None
               ) -> List[MaterializedModel]:
        return [m for m in self.models(kind) if query.contains(m.o)]

    def nbytes(self) -> int:
        return sum(m.nbytes() for m in self.models())

    # --- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        maybe_fail("store.save")
        os.makedirs(path, exist_ok=True)
        manifest = {"next_id": self._next_id, "models": []}
        for m in self.models():
            blob = os.path.join(path, f"model_{m.model_id}.npz")
            with tempfile.NamedTemporaryFile(dir=path, delete=False) as f:
                np.savez(f, **m.theta)
                f.flush()
                os.fsync(f.fileno())
                tmp = f.name
            os.replace(tmp, blob)
            manifest["models"].append({
                "model_id": m.model_id,
                "lo": m.o.lo, "hi": m.o.hi,
                "n_docs": m.n_docs, "n_tokens": m.n_tokens,
                "kind": m.kind,
                "sha": _sha(blob),
                "file": os.path.basename(blob),
            })
        mf = os.path.join(path, "manifest.json")
        with tempfile.NamedTemporaryFile("w", dir=path, delete=False) as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
            tmp = f.name
        os.replace(tmp, mf)
        _fsync_dir(path)
        # prune blobs of models removed since the last save.  Only ids
        # this store has allocated (< next_id) are candidates — a fresh
        # or stale store saving into a shared directory must not delete
        # blobs it never knew about.
        live = {e["file"] for e in manifest["models"]}
        for name in os.listdir(path):
            m = _BLOB_RE.fullmatch(name)
            if m is None or name in live:
                continue
            if 0 <= int(m.group(1)) < self._next_id:
                os.remove(os.path.join(path, name))

    @classmethod
    def load(cls, path: str, verify: bool = True,
             on_corrupt: str = "raise") -> "ModelStore":
        """Restore a saved store.

        ``on_corrupt="raise"`` (legacy): the first bad blob aborts the
        load with ``CorruptModelError`` (an ``IOError``).
        ``on_corrupt="quarantine"``: bad blobs are skipped, recorded
        in ``store.quarantined`` with their manifest interval/kind,
        and every healthy model still loads — queries covering the
        hole plan around it (gap-train or alternate cover).
        """
        maybe_fail("store.load")
        if on_corrupt not in ("raise", "quarantine"):
            raise ValueError(
                f"on_corrupt must be 'raise' or 'quarantine', "
                f"got {on_corrupt!r}")
        store = cls()
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        store._next_id = manifest["next_id"]
        for e in manifest["models"]:
            blob = os.path.join(path, e["file"])
            reason = None
            theta = None
            try:
                if verify and _sha(blob) != e["sha"]:
                    reason = "checksum mismatch"
                else:
                    with np.load(blob) as z:
                        theta = {k: z[k] for k in z.files}
            except CorruptModelError:
                raise
            except Exception as exc:  # truncated zip, missing file, ...
                reason = f"unreadable ({type(exc).__name__}: {exc})"
            if reason is not None:
                if on_corrupt == "raise":
                    raise CorruptModelError(
                        f"{reason} for {blob}",
                        model_id=e["model_id"], blob=blob)
                store.quarantined.append(QuarantinedBlob(
                    model_id=e["model_id"], file=e["file"], reason=reason,
                    o=Interval(e["lo"], e["hi"]), kind=e["kind"]))
                continue
            m = MaterializedModel(
                e["model_id"], Interval(e["lo"], e["hi"]),
                e["n_docs"], e["n_tokens"], e["kind"], theta)
            store._models[m.model_id] = m
        return store


def models_from_numpy(records: Sequence) -> List[MaterializedModel]:
    """Build the port's ``MaterializedModel``s from plain records.

    Each record is a mapping or an object (the JAX package's
    ``MaterializedModel`` is one) with the fields ``model_id``, ``o``
    (anything with ``lo`` and ``hi``), ``n_docs``, ``n_tokens``,
    ``kind`` and ``theta`` (a dict of arrays).  Only those plain fields
    are read, and every ``theta`` entry is copied into a float32 NumPy
    array, so nothing of the other package is imported or kept.
    """
    out = []
    for r in records:
        get = r.get if isinstance(r, dict) else (
            lambda name, _r=r: getattr(_r, name))
        o = get("o")
        out.append(MaterializedModel(
            int(get("model_id")), Interval(float(o.lo), float(o.hi)),
            int(get("n_docs")), int(get("n_tokens")), str(get("kind")),
            {k: np.array(v, dtype=np.float32)
             for k, v in get("theta").items()}))
    return out


def _fsync_dir(path: str) -> None:
    """Make the renames themselves durable (POSIX: fsync the directory)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse directory fsync; best-effort
    finally:
        os.close(fd)


def _sha(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
