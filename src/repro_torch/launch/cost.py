"""What one step costs each device: product FLOPs, HBM bytes, link bytes.

The port of ``src/repro/launch/hlo_analyzer.py`` and ``hlo_stats.py``.
JAX reads these numbers off the optimised HLO text, and has to walk the
call graph to multiply each ``while`` body by its trip count, because
XLA's own cost analysis visits a loop body once.  The port runs eagerly:
every layer, chunk and time step is an operation that happens, so
:class:`OpCounter`, a ``TorchDispatchMode``, sees each one as it runs and
needs no trip counts.  Under ``FakeTensorMode`` (shapes only, no storage:
``launch/dryrun.py``) it costs a full-size step without a byte of it.

Per device (the device a tensor lies on):

  * ``flops`` — the product ops only, as ``hlo_analyzer.py``'s
    ``_dot_flops`` counts dots only: ``mm``, ``bmm``, ``addmm`` and
    ``baddbmm`` (``matmul``, ``einsum`` and ``linear`` reach the counter
    as these; under ``torch.inference_mode``, which hands the counter a
    composite op whole, the counter decomposes it itself), 2 · numel(out)
    · K each, charged to the output's device;
    and each kernel's products, reported by its wrapper
    (:func:`report_kernel`);
  * ``hbm_bytes`` — every eager op is a kernel boundary, as a fusion is
    in ``hlo_analyzer.py:310``, so an op moves its operands' and its
    outputs' bytes (each charged to its tensor's device).  Views move
    nothing.  ``index_select``, ``gather`` and indexing read only the
    rows they produce (2 · out + the indices); ``index_copy_``,
    ``index_put_``, ``scatter_`` and a ``copy_`` into a view write only
    the rows they are given (2 · the values + the indices), as
    ``hlo_analyzer.py:271-291`` charges gathers, dynamic slices and
    dynamic-update-slices;
  * ``hbm_bytes_kernel_interior`` — the part of ``hbm_bytes`` that ops
    inside a :func:`kernel_interior` region moved: the plain math a
    kernel would keep on chip (JAX's ``named_scope("kernel_interior")``);
  * collective wire bytes, counts and bytes by kind, from the ring
    formulas of ``hlo_stats.py:1-17`` per cell: all-reduce
    2 · size · (n − 1)/n, all-gather (size of the gathered result) and
    all-to-all size · (n − 1)/n, collective-permute size.  The
    collectives of ``distributed/sharding.py`` report themselves
    (:func:`report_collective`) with their group size and each cell's
    bytes; a copy between devices is not read as a collective, because
    a single-controller copy is not the ring's traffic.  The bytes those
    copies move are kept apart, as ``copy_bytes_in`` (bytes a device
    receives from another device);
  * the all-gathers' reads: the storages of the pieces each all-gather
    read and the mesh axes it gathered over (``OpCounter.gathered``), from
    which ``launch/dryrun.py`` names the weight leaves a step gathers;
  * memory — the bytes of the live storages on each device: those the
    caller registers (:meth:`OpCounter.track`, the step's arguments) and
    every storage an op creates, until the last tensor on it dies; the
    peak of that sum is the step's peak.  An eager allocator holds about
    this much (the caching allocator's rounding and fragmentation aside).

Each of the LM kernels' wrappers (flash, decode, sLSTM) reports every
launch, its shape-only route's (a fake tensor on a device other than the
CPU) and a real one, with its kernel's ``cost(...)``: the bytes of its
inputs read once and its outputs written once, and its products' FLOPs,
as ``PERF.md`` §6's bounds count them (a decode launch whose position is
a tensor counts the whole cache: the count never reads the device).  So
a real step and its dry run count the same.

``reanalyze.py`` (re-reading saved HLO text) has no counterpart: there is
no HLO here, and a dry run is cheap to run again.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

_PRODUCTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm}
# ops that read only the rows they produce
_GATHERS = {aten.index_select, aten.gather, aten.index, aten.embedding}
# in-place ops that write only the rows (values) they are given, by the
# position of their values argument
_SCATTERS = {aten.index_copy_: 3, aten.index_put_: 2,
             aten._index_put_impl_: 2, aten.scatter_: 3, aten.index_add_: 3,
             aten.scatter_add_: 3}
# ops that allocate without writing, and ops that write without reading
_ALLOCS = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
           aten.new_empty_strided}
_WRITES = {aten.zero_, aten.fill_}


@dataclasses.dataclass
class DeviceCost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    hbm_bytes_kernel_interior: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    collective_bytes_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    copy_bytes_in: float = 0.0
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_flops: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    live_bytes: int = 0
    peak_bytes: int = 0


def _tensors(x) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def nbytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s elements (a view's own, not its base's)."""
    return t.numel() * t.element_size()


def _product_flops(func, args, out) -> float:
    """2 · numel(out) · K of a product op (K: the contracted length)."""
    a = args[1] if func in (aten.addmm, aten.baddbmm) else args[0]
    return 2.0 * out.numel() * a.shape[-1]


_ACTIVE: List["OpCounter"] = []
_active_lock = threading.Lock()
_NULL = contextlib.nullcontext()


def active() -> Optional["OpCounter"]:
    """The innermost :class:`OpCounter` that is counting, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def kernel_interior():
    """Marks the ops run inside it as the plain math a kernel keeps on chip
    (JAX's ``named_scope("kernel_interior")``): the active counter adds
    their bytes to ``hbm_bytes_kernel_interior`` as well.  Without a
    counter, a shared no-op context."""
    c = active()
    return _NULL if c is None else c.interior()


def report_kernel(name: str, device: torch.device, cost: Callable) -> None:
    """One launch of the kernel ``name`` on ``device`` (its shape-only
    route's or a real one) and ``cost()`` (a ``kernels.common.Cost``, made
    only when a counter is active) to the active counter; nothing without
    one."""
    c = active()
    if c is not None:
        c.add_kernel(name, cost(), device)


def report_collective(kind: str, n: int, cells: Iterable[torch.Tensor],
                      *, reads: Iterable[torch.Tensor] = (),
                      axes: Tuple[str, ...] = ()) -> None:
    """One collective over a group of ``n`` cells; ``cells`` the tensor
    each cell's term reads (its own block, or for an all-gather the
    gathered result), charged to that tensor's device by the ring formula
    of ``kind``.  An all-gather also names the pieces it ``reads`` and the
    mesh ``axes`` it gathers over: the counter notes their storages
    (``OpCounter.gathered``), so a dry run can tell which weight leaves a
    step gathers.  Nothing without an active counter."""
    c = active()
    if c is None:
        return
    frac = (n - 1) / max(n, 1)
    for t in cells:
        size = nbytes(t)
        wire = (2.0 * size * frac if kind == "all-reduce"
                else float(size) if kind == "collective-permute"
                else size * frac)
        c.add_collective(kind, wire, t.device)
    if kind == "all-gather":
        c.add_gathered(reads, tuple(axes))


class OpCounter(TorchDispatchMode):
    """Counts what the ops run inside it cost each device (module
    docstring).  ``with OpCounter() as c: step(...)``; then ``c.devices``
    maps each device to its :class:`DeviceCost`.  Enter it inside a
    ``FakeTensorMode`` to cost a step that allocates nothing."""

    def __init__(self):
        super().__init__()
        self.devices: Dict[torch.device, DeviceCost] = {}
        # each all-gather's (storages of the pieces it read, mesh axes)
        self.gathered: List[Tuple[frozenset, Tuple[str, ...]]] = []
        self._storages: Dict[int, tuple] = {}
        self._interior = 0
        self._lock = threading.Lock()

    def dev(self, device: torch.device) -> DeviceCost:
        got = self.devices.get(device)
        if got is None:
            got = self.devices[device] = DeviceCost()
        return got

    # --- the step's memory --------------------------------------------------
    def track(self, tree: Any) -> Dict[torch.device, int]:
        """Registers the storages of every tensor in ``tree`` (nested
        dicts, lists, tuples) as live; returns the bytes of its distinct
        storages per device."""
        for t in _tensors(tree):
            self._register(t)
        return storage_bytes(tree)

    def _register(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        with self._lock:
            if key in self._storages:
                return
            n = st.nbytes()
            self._storages[key] = (t.device, n)
            d = self.dev(t.device)
            d.live_bytes += n
            d.peak_bytes = max(d.peak_bytes, d.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        with self._lock:
            got = self._storages.pop(key, None)
            if got is not None:
                self.devices[got[0]].live_bytes -= got[1]

    # --- reports ------------------------------------------------------------
    @contextlib.contextmanager
    def interior(self):
        self._interior += 1
        try:
            yield
        finally:
            self._interior -= 1

    def _bytes(self, device: torch.device, n: float) -> None:
        d = self.dev(device)
        d.hbm_bytes += n
        if self._interior:
            d.hbm_bytes_kernel_interior += n

    def add_kernel(self, name: str, cost, device: torch.device) -> None:
        d = self.dev(device)
        d.flops += cost.flops
        self._bytes(device, cost.n_bytes)
        d.kernel_launches[name] = d.kernel_launches.get(name, 0) + 1
        d.kernel_flops[name] = d.kernel_flops.get(name, 0.0) + cost.flops
        d.kernel_bytes[name] = d.kernel_bytes.get(name, 0.0) + cost.n_bytes

    def add_collective(self, kind: str, wire: float,
                       device: torch.device) -> None:
        d = self.dev(device)
        d.collective_wire_bytes += wire
        d.collective_counts[kind] = d.collective_counts.get(kind, 0) + 1
        d.collective_bytes_by_kind[kind] = (
            d.collective_bytes_by_kind.get(kind, 0.0) + wire)

    def add_gathered(self, reads: Iterable[torch.Tensor],
                     axes: Tuple[str, ...]) -> None:
        """One all-gather over ``axes`` that read ``reads``."""
        keys = frozenset(t.untyped_storage()._cdata
                         for t in _tensors(list(reads)))
        with self._lock:
            self.gathered.append((keys, axes))

    # --- the dispatch -------------------------------------------------------
    def __enter__(self):
        with _active_lock:
            _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        with _active_lock:
            _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # under ``torch.inference_mode`` a composite op (``matmul``, ``to``)
        # arrives whole: count the ops it is made of, as outside it
        if func.namespace == "aten" and torch.is_inference_mode_enabled():
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        outs = list(_tensors(out))
        for t in outs:
            self._register(t)
        if packet in _PRODUCTS:
            self.dev(outs[0].device).flops += _product_flops(packet, args,
                                                             outs[0])
        self._count_bytes(func, packet, args, kwargs, outs)
        return out

    def _count_bytes(self, func, packet, args, kwargs, outs) -> None:
        schema = func._schema
        if packet in _ALLOCS or not outs:
            return
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in schema.returns):
            return                                   # a view: no traffic
        if packet in _GATHERS:
            for t in outs:
                self._bytes(t.device, 2.0 * nbytes(t))
            for t in list(_tensors(args))[1:]:
                if not t.is_floating_point():
                    self._bytes(t.device, nbytes(t))  # the indices
            return
        if packet in _SCATTERS:
            i = _SCATTERS[packet]
            idx = list(_tensors(args[1:i]))
            vals = args[i] if len(args) > i else None
            rows = (nbytes(vals) if isinstance(vals, torch.Tensor)
                    else sum(t.numel() for t in idx) * outs[0].element_size())
            self._bytes(outs[0].device, 2.0 * rows)
            for t in idx:
                self._bytes(t.device, nbytes(t))
            return
        if packet in _WRITES:
            self._bytes(outs[0].device, nbytes(outs[0]))
            return
        if packet is aten.copy_:
            dst, src = args[0], args[1]
            self._bytes(src.device, nbytes(src))
            self._bytes(dst.device, nbytes(dst))
            if src.device != dst.device:
                self.dev(dst.device).copy_bytes_in += nbytes(src)
            return
        ins = list(_tensors((args, kwargs)))
        for t in ins + outs:         # in place: self read, then written
            self._bytes(t.device, nbytes(t))
        if packet is aten._to_copy and ins and outs[0].device != \
                ins[0].device:
            self.dev(outs[0].device).copy_bytes_in += nbytes(outs[0])

    # --- reading ------------------------------------------------------------
    def busiest(self, field: str = "peak_bytes") -> torch.device:
        """The device whose ``field`` is largest (the first on a tie)."""
        return max(self.devices, key=lambda d: getattr(self.devices[d],
                                                       field))

    def total(self, field: str) -> float:
        return sum(getattr(d, field) for d in self.devices.values())

    def max(self, field: str) -> float:
        return max((getattr(d, field) for d in self.devices.values()),
                   default=0.0)

    def per_kernel(self, field: str) -> Dict[str, float]:
        """``field`` (``"kernel_launches"``, ``"kernel_flops"`` or
        ``"kernel_bytes"``) of each kernel, summed over devices."""
        out: Dict[str, float] = {}
        for d in self.devices.values():
            for k, n in getattr(d, field).items():
                out[k] = out.get(k, 0) + n
        return out


def storage_bytes(tree: Any) -> Dict[torch.device, int]:
    """The bytes of the distinct storages of ``tree``'s tensors, per
    device."""
    seen = set()
    out: Dict[torch.device, int] = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        if st._cdata in seen:
            continue
        seen.add(st._cdata)
        out[t.device] = out.get(t.device, 0) + st.nbytes()
    return out
