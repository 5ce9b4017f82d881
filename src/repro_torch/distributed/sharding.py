"""Mesh environment of the port: a grid of devices, its sharding rules and
the collectives over its cells.

The port of ``src/repro/distributed/sharding.py``.  JAX's ``MeshEnv`` wraps
a ``jax.sharding.Mesh``: a value carries a ``NamedSharding`` and its
collectives run inside ``shard_map``.  The port is *single-controller*:
one process drives every cell.  A ``MeshEnv`` is a grid of
``torch.device``s with named axes, ("data", "model") by default and
("stage",) for the pipeline; a sharded value is a Python list of one
tensor per grid cell, in rank order (row-major over the axes), each on
its cell's device.  A collective is a plain function over those lists:

  * :func:`all_reduce` / :func:`psum` add the cells' tensors in rank order
    on the first cell's device and send the sum back;
  * :func:`ppermute` moves each cell's tensor to its neighbour along an
    axis; :func:`all_gather` concatenates an axis's tensors on every cell;
    :func:`all_to_all` exchanges the blocks of an axis's tensors.

So the port needs no ``torch.distributed`` and no process group, and every
reduction gives the same bits on every run.  A grid may name one device
several times: a (1, 4) grid of ``cuda:0`` holds four sequence shards on
one card, and a (2, 4) grid of ``"cpu"`` stands in for the eight host
devices the JAX tests force.  A copy onto the same device is no copy
(``Tensor.to`` returns the tensor itself), and work that JAX replicates
runs once per *distinct* device: cells whose inputs are the same tensors
share one result (:func:`cellwise`), and a gather onto a device that
already holds the whole tensor returns it (:func:`unshard`).

Each collective (and the weight gather of :func:`gather_for_compute`,
JAX's all-gather) reports itself to a dry run's counter
(``launch.cost.report_collective``): its kind, group size and each
cell's bytes, charged to the cell's device by the ring formula; without
a counter the report does nothing.

The LM rules are JAX's, rule for rule: :func:`infer_param_specs`
(``_spec_for``), :func:`batch_specs`, :func:`cache_specs`, read only a
leaf's path and shape.  The port keeps per-layer lists where JAX stacks
layers on a leading axis (``"layers/3/attn/wq"`` has no ``"stack"``), so
a port leaf's spec is JAX's for the same leaf with the stacked lead entry
dropped.  :func:`shard` and :func:`unshard` split a tensor into its cells'
pieces and join them back (the port's ``param_shardings`` and
``shardings_of`` give :class:`NamedSharding`s that do both);
:func:`gather_for_compute` all-gathers one layer's weights once per
distinct device (the prefill and the loss); :func:`pieces`,
:func:`sharded_dot` and :func:`sharded_take` multiply by a weight and
look rows up in a table that stay in their pieces, moving activations
only (a decode step, weight-stationary as JAX's); :func:`constrain`
lays an activation out by JAX's logical names.  For an update on the
pieces (``train/optim.py``): :func:`relayout` lays a cut tensor out by
another spec without joining it, :func:`sum_replicas` adds a part's
copies on distinct devices (a replicated weight's gradients),
:func:`zeros` makes a cut tensor piece by piece, and :func:`own_pieces`
copies the pieces that are views, so no whole tensor stays alive behind
them.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.launch.cost import report_collective

DeviceLike = Union[str, torch.device]
Cells = List[Any]          # one value per grid cell, in rank order


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: one entry per dimension, ``None``
    (replicated), an axis name, or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class Sharded(list):
    """A tensor's pieces, one per grid cell in rank order, with the
    ``spec`` that cut them (what :func:`shard` returns)."""

    def __init__(self, pieces, spec=None):
        super().__init__(pieces)
        self.spec = spec


def _flatten(grid, depth: int) -> List[Any]:
    if depth == 0:
        return [grid]
    return [x for row in grid for x in _flatten(row, depth - 1)]


def _grid_shape(grid, depth: int) -> Tuple[int, ...]:
    if depth == 0:
        return ()
    if not isinstance(grid, (tuple, list)) or not grid:
        raise ValueError("a mesh is a non-empty rectangular grid of devices")
    inner = {_grid_shape(row, depth - 1) for row in grid}
    if len(inner) != 1:
        raise ValueError("a mesh is a non-empty rectangular grid of devices")
    return (len(grid),) + inner.pop()


def _resolve(grid, depth: int):
    if depth == 0:
        return resolve_device(grid)
    return tuple(_resolve(row, depth - 1) for row in grid)


@dataclass(frozen=True)
class MeshEnv:
    """``devices`` nests one level per axis of ``axis_names``: for the
    default ("data", "model") ``devices[d][m]`` is the device of data rank
    d, model shard m; for ("stage",) ``devices[s]`` is stage s's.
    ``profile`` ("train" | "serve") selects the weight rules of
    :func:`infer_param_specs`, as in JAX."""

    devices: Tuple
    axis_names: Tuple[str, ...] = ("data", "model")
    profile: str = "train"

    def __post_init__(self):
        names = tuple(self.axis_names)
        try:
            shape = _grid_shape(self.devices, len(names))
        except (ValueError, TypeError):
            raise ValueError(f"a mesh is a non-empty rectangular grid of "
                             f"devices, got {self.devices!r}") from None
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "devices", _resolve(self.devices,
                                                     len(names)))
        object.__setattr__(self, "_shape", shape)
        object.__setattr__(self, "_cells",
                           tuple(_flatten(self.devices, len(names))))

    @property
    def shape(self) -> Tuple[int, ...]:
        """The axes' sizes, in ``axis_names`` order."""
        return self._shape

    @property
    def cells(self) -> Tuple[torch.device, ...]:
        """Every cell's device, in rank order (row-major)."""
        return self._cells

    @property
    def n_cells(self) -> int:
        return len(self._cells)

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in ("pod", "data") if a in self.axis_names)

    @property
    def tp_axis(self) -> Optional[str]:
        return "model" if "model" in self.axis_names else None

    def size(self, axis) -> int:
        if axis is None:
            return 1
        if isinstance(axis, (tuple, list)):
            out = 1
            for a in axis:
                out *= self.size(a)
            return out
        if axis not in self.axis_names:
            raise ValueError(f"unknown mesh axis {axis!r}")
        return self._shape[self.axis_names.index(axis)]

    @property
    def dp_size(self) -> int:
        return self.size(self.dp_axes)

    @property
    def tp_size(self) -> int:
        return self.size(self.tp_axis)

    @property
    def first(self) -> torch.device:
        """The device of cell 0: reductions land here."""
        return self._cells[0]

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The grid's devices without repeats, in cell order."""
        return tuple(dict.fromkeys(self._cells))

    def coords(self, c: int) -> Tuple[int, ...]:
        """Cell c's coordinate along each axis."""
        out = []
        for n in reversed(self._shape):
            out.append(c % n)
            c //= n
        return tuple(reversed(out))

    def index(self, coords: Sequence[int]) -> int:
        c = 0
        for x, n in zip(coords, self._shape):
            c = c * n + x
        return c

    def axis_index(self, c: int, axis) -> int:
        """Cell c's rank along ``axis`` (a tuple of axes: row-major)."""
        if axis is None:
            return 0
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        co = self.coords(c)
        idx = 0
        for a in axes:
            idx = idx * self.size(a) + co[self.axis_names.index(a)]
        return idx

    def group(self, c: int, axis: str) -> List[int]:
        """The cells along ``axis`` that share cell c's other coordinates,
        in rank order."""
        i = self.axis_names.index(axis)
        co = list(self.coords(c))
        out = []
        for x in range(self._shape[i]):
            co[i] = x
            out.append(self.index(co))
        return out


_LOCAL = threading.local()


def get_env() -> Optional[MeshEnv]:
    return getattr(_LOCAL, "env", None)


@contextlib.contextmanager
def set_env(env: MeshEnv):
    prev = get_env()
    _LOCAL.env = env
    try:
        yield env
    finally:
        _LOCAL.env = prev


def single_device_env(device: Optional[DeviceLike] = None,
                      profile: str = "train") -> MeshEnv:
    """A (1, 1) grid over ``device`` (the current card by default)."""
    return MeshEnv(((resolve_device(device),),), profile=profile)


def local_mesh_env(device: Optional[DeviceLike] = None,
                   max_devices: Optional[int] = None) -> MeshEnv:
    """A (1, n) grid over every local CUDA device, "model" as the TP axis.

    This is the vocab-sharded merge topology: the whole model list is
    replicated over the (trivial) data axis and each device owns a
    ``V/n`` vocab slice.  The grid starts at ``device`` (the current card
    by default) and takes the other cards in index order after it, so
    gap training, which runs on the first cell, stays on the caller's
    card.  ``max_devices`` caps the shard count.  Without a card it
    raises, unless ``device="cpu"``, which gives one CPU shard.
    """
    first = resolve_device(device)
    if first.type != "cuda":
        return MeshEnv(((first,),))
    count = torch.cuda.device_count()
    n = count if max_devices is None else max(1, min(count, max_devices))
    return MeshEnv((tuple(torch.device("cuda", (first.index + i) % count)
                          for i in range(n)),))


# ---------------------------------------------------------------------------
# pieces of a tensor: shard / unshard
# ---------------------------------------------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _full_spec(spec, ndim: int) -> Tuple:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return spec + (None,) * (ndim - len(spec))


def _piece_index(env: MeshEnv, c: int, spec) -> Tuple[int, ...]:
    return tuple(env.axis_index(c, _axes(e) or None) for e in spec)


def shard(t: torch.Tensor, spec, env: MeshEnv) -> Cells:
    """``t`` split by ``spec`` into one piece per cell, each on its cell's
    device: a dimension named by an axis (or axes) is cut into that many
    equal parts, a ``None`` dimension is whole.  Cells that hold the same
    part on the same device share one tensor, and a part on ``t``'s own
    device is a view of ``t`` (no copy)."""
    spec = _full_spec(spec, t.dim())
    for dim, e in enumerate(spec):
        if t.shape[dim] % env.size(_axes(e)) != 0:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} is not "
                             f"divisible by {_axes(e)} of the mesh")
    made: Dict[Tuple, torch.Tensor] = {}
    out = []
    for c, dev in enumerate(env.cells):
        key = (_piece_index(env, c, spec), dev)
        if key not in made:
            piece = t
            for dim, (e, i) in enumerate(zip(spec, key[0])):
                n = env.size(_axes(e))
                if n > 1:
                    step = t.shape[dim] // n
                    piece = piece.narrow(dim, i * step, step)
            made[key] = piece.to(dev)
        out.append(made[key])
    return Sharded(out, P(*spec))


def _whole_base(parts: Dict[Tuple, torch.Tensor], spec, sizes, shape,
                device) -> Optional[torch.Tensor]:
    """The tensor the parts are views of, when they tile it exactly as
    :func:`shard` cut it and it lies on ``device``: joining them again is
    then no copy."""
    root = next(iter(parts.values()))._base
    if root is None or root.device != device:
        return None
    # pieces that are autograd leaves of their own are not views to join
    # through: their gradients must reach them, not the tensor below
    if any(p.requires_grad and (p.grad_fn is None or not root.requires_grad)
           for p in parts.values()):
        return None
    base = root
    if tuple(root.shape) != shape:
        n = 1
        for x in shape:
            n *= x
        if not root.is_contiguous() or root.numel() != n:
            return None
        base = root.view(shape)
    for idx, p in parts.items():
        want = base
        for dim, (n, i) in enumerate(zip(sizes, idx)):
            if n > 1:
                step = shape[dim] // n
                want = want.narrow(dim, i * step, step)
        if (p._base is not root or p.storage_offset() != want.storage_offset()
                or p.shape != want.shape or p.stride() != want.stride()):
            return None
    return base


class _Fanout(torch.autograd.Function):
    """x -> one tensor per device of ``devices`` (x itself on its own
    device).  The backward adds the copies' gradients in device order on
    x's device, so a gradient summed across devices has a fixed order."""

    @staticmethod
    def forward(ctx, x, devices):
        ctx.src = x.device
        return tuple(x.view_as(x) if d == x.device else x.to(d)
                     for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = None
        for g in grads:
            if g is not None:
                g = g.to(ctx.src)
                total = g if total is None else total + g
        return total, None


def _needs_fanout(tensors, devices) -> bool:
    return (torch.is_grad_enabled() and len(devices) > 1
            and any(t.requires_grad for t in tensors))


def unshard(cells: Cells, spec=None, env: MeshEnv = None,
            device: Optional[DeviceLike] = None) -> torch.Tensor:
    """The whole tensor on ``device`` (the first cell's by default) from
    the cells' pieces laid out by ``spec``: for each part the first cell
    that holds it, joined along the sharded dimensions.  When the parts
    are views that tile one tensor on ``device`` (what :func:`shard` gives
    on a grid that repeats that device), that tensor itself.  ``spec``
    defaults to a :class:`Sharded`'s own."""
    if spec is None:
        spec = cells.spec
    dev = env.first if device is None else resolve_device(device)
    spec = _full_spec(spec, cells[0].dim())
    sizes = [env.size(_axes(e)) for e in spec]
    parts: Dict[Tuple, torch.Tensor] = {}
    for c in range(env.n_cells):
        parts.setdefault(_piece_index(env, c, spec), cells[c])
    if len(parts) == 1:
        return next(iter(parts.values())).to(dev)
    shape = tuple(p * n for p, n in zip(next(iter(parts.values())).shape,
                                        sizes))
    base = _whole_base(parts, spec, sizes, shape, dev)
    if base is not None:
        return base

    def build(dim: int, prefix: Tuple[int, ...]) -> torch.Tensor:
        if dim == len(spec):
            return parts[prefix].to(dev)
        if sizes[dim] == 1:
            return build(dim + 1, prefix + (0,))
        return torch.cat([build(dim + 1, prefix + (i,))
                          for i in range(sizes[dim])], dim)

    return build(0, ())


def replicate(t: torch.Tensor, env: MeshEnv) -> Cells:
    """``t`` whole on every cell (one tensor per distinct device)."""
    return shard(t, (), env)


def whole_shape(cells: Sharded, env: MeshEnv) -> Tuple[int, ...]:
    """The shape of the tensor a ``Sharded``'s pieces cut."""
    spec = _full_spec(cells.spec, cells[0].dim())
    return tuple(n * env.size(_axes(e)) for n, e in zip(cells[0].shape,
                                                          spec))


def distinct_pieces(cells: Sharded, env: MeshEnv) -> List[torch.Tensor]:
    """One tensor per part of a ``Sharded`` (the first cell's that holds
    it), in the order of the parts' indices: a replicated part counts
    once, not once per cell or device."""
    spec = _full_spec(cells.spec, cells[0].dim())
    first: Dict[Tuple[int, ...], torch.Tensor] = {}
    for c in range(env.n_cells):
        first.setdefault(_piece_index(env, c, spec), cells[c])
    return [first[k] for k in sorted(first)]


def own_pieces(cells: Sharded) -> Sharded:
    """``cells`` with each piece that is a view of a larger tensor copied
    (once per distinct piece), so the larger tensor can be freed."""
    made: Dict[int, torch.Tensor] = {}
    for t in cells:
        if id(t) not in made:
            view = t.untyped_storage().nbytes() > t.numel() * t.element_size()
            made[id(t)] = t.clone() if view else t
    return Sharded([made[id(t)] for t in cells], cells.spec)


def zeros(shape: Sequence[int], spec, env: MeshEnv,
          dtype: torch.dtype = torch.float32) -> Sharded:
    """Zeros of ``shape`` laid out by ``spec``, made piece by piece on
    each cell's device (no whole tensor anywhere)."""
    spec = _full_spec(spec, len(shape))
    piece = []
    for dim, (n, e) in enumerate(zip(shape, spec)):
        if n % env.size(_axes(e)):
            raise ValueError(f"dim {dim} of {tuple(shape)} is not "
                             f"divisible by {_axes(e)} of the mesh")
        piece.append(n // env.size(_axes(e)))
    made: Dict[Tuple, torch.Tensor] = {}
    out = []
    for c, dev in enumerate(env.cells):
        key = (_piece_index(env, c, spec), dev)
        if key not in made:
            made[key] = torch.zeros(piece, dtype=dtype, device=dev)
        out.append(made[key])
    return Sharded(out, P(*spec))


def relayout(cells: Sharded, spec, env: MeshEnv) -> Sharded:
    """The tensor of ``cells`` laid out by ``spec`` instead of its own
    spec: each cell's new piece joined from the parts of the old pieces
    that overlap it (an old piece on the cell's own device where there is
    one), once per distinct (part, device).  No whole tensor is built
    unless ``spec`` replicates it.  A new piece that one old piece covers
    is a view of it."""
    ndim = cells[0].dim()
    src, dst = _full_spec(cells.spec, ndim), _full_spec(spec, ndim)
    if src == dst:
        return cells
    shape = whole_shape(cells, env)
    n_src = [env.size(_axes(e)) for e in src]
    n_dst = [env.size(_axes(e)) for e in dst]
    held: Dict[Tuple[int, ...], Dict[torch.device, torch.Tensor]] = {}
    for c, t in enumerate(cells):
        held.setdefault(_piece_index(env, c, src), {}).setdefault(t.device,
                                                                  t)
    made: Dict[Tuple, torch.Tensor] = {}
    out = []
    for c, dev in enumerate(env.cells):
        idx = _piece_index(env, c, dst)
        if (idx, dev) not in made:
            # per dim: (old part, start in it, length) of each overlap
            spans = []
            for dim in range(ndim):
                bs, bd = shape[dim] // n_src[dim], shape[dim] // n_dst[dim]
                lo, hi = idx[dim] * bd, (idx[dim] + 1) * bd
                spans.append([(j, max(lo, j * bs) - j * bs,
                               min(hi, (j + 1) * bs) - max(lo, j * bs))
                              for j in range(lo // bs, (hi - 1) // bs + 1)])

            def build(dim: int, picked: List[Tuple[int, int, int]]):
                if dim == ndim:
                    have = held[tuple(j for j, _, _ in picked)]
                    t = have.get(dev, next(iter(have.values())))
                    for d, (_, start, n) in enumerate(picked):
                        if n != t.shape[d]:
                            t = t.narrow(d, start, n)
                    return t.to(dev)
                parts = [build(dim + 1, picked + [s]) for s in spans[dim]]
                return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

            made[(idx, dev)] = build(0, [])
        out.append(made[(idx, dev)])
    return Sharded(out, P(*dst))


def sum_replicas(cells: Sharded, env: MeshEnv) -> Sharded:
    """Where cells on distinct devices hold one part of a ``Sharded`` in
    tensors of their own (a replicated weight's gradients, one per device
    that used it), those tensors added in cell order on the first one's
    device and the sum sent to each: JAX's sum over the replicas.  A grid
    that repeats one device holds each part in one tensor and gets
    ``cells`` back as they are."""
    spec = _full_spec(cells.spec, cells[0].dim())
    holders: Dict[Tuple[int, ...], List[int]] = {}
    for c in range(env.n_cells):
        holders.setdefault(_piece_index(env, c, spec), []).append(c)
    out = list(cells)
    for group in holders.values():
        uniq = list({id(cells[c]): cells[c] for c in group}.values())
        if len(uniq) == 1:
            continue
        report_collective("all-reduce", len(uniq), uniq)
        total = uniq[0]
        for t in uniq[1:]:
            total = total + t.to(total.device)
        sent: Dict[torch.device, torch.Tensor] = {}
        for c in group:
            dev = cells[c].device
            if dev not in sent:
                sent[dev] = total.to(dev)
            out[c] = sent[dev]
    return Sharded(out, cells.spec)


def cellwise(fn: Callable, *cell_lists: Cells) -> Cells:
    """``fn`` applied to each cell's arguments, once per distinct
    argument tuple: cells whose arguments are the same objects (work that
    JAX replicates, on one device) share one result."""
    n = len(cell_lists[0])
    done: Dict[Tuple[int, ...], Any] = {}
    out = []
    for c in range(n):
        args = tuple(cl[c] for cl in cell_lists)
        key = tuple(id(a) for a in args)
        if key not in done:
            done[key] = fn(*args)
        out.append(done[key])
    return out


def unzip(cells: Cells) -> Tuple[Cells, ...]:
    """A list of per-cell tuples as a tuple of cell lists."""
    return tuple(list(x) for x in zip(*cells))


def cell_trees(tree: Any, n: int) -> List[Any]:
    """A tree whose leaves are cell lists as one tree per cell; cells
    whose leaves are all the same objects share one tree."""
    def pick(node, c):
        if isinstance(node, dict):
            return {k: pick(v, c) for k, v in node.items()}
        return node[c]

    def leaf_ids(node, c):
        if isinstance(node, dict):
            return tuple(x for k in node for x in leaf_ids(node[k], c))
        return (id(node[c]),)

    made: Dict[Tuple[int, ...], Any] = {}
    out = []
    for c in range(n):
        key = leaf_ids(tree, c)
        if key not in made:
            made[key] = pick(tree, c)
        out.append(made[key])
    return out


# ---------------------------------------------------------------------------
# collectives over the cells
# ---------------------------------------------------------------------------

def all_reduce(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum one tensor per cell; every cell gets the sum on its device.

    The sum is taken in the order given, on the first tensor's device,
    then copied to each cell's device (a copy onto the same device is
    no copy): the same bits on every run, where a ``psum`` may add in
    any order.  Returns one tensor per input, in input order."""
    report_collective("all-reduce", len(tensors), tensors)
    total = tensors[0]
    for t in tensors[1:]:
        total = total + t.to(total.device)
    return [total if t.device == total.device else total.to(t.device)
            for t in tensors]


def _groups(env: MeshEnv, axes: Tuple[str, ...]) -> List[List[int]]:
    """The cells partitioned into groups that differ only along ``axes``,
    each group in rank order along them."""
    others = [a for a in env.axis_names if a not in axes]
    seen: Dict[Tuple[int, ...], List[int]] = {}
    for c in range(env.n_cells):
        key = tuple(env.axis_index(c, a) for a in others)
        seen.setdefault(key, []).append(c)
    return list(seen.values())


def psum(cells: Cells, env: MeshEnv, axis) -> Cells:
    """JAX's ``psum`` over ``axis`` (a name or a tuple of names): each
    group's tensors added in rank order on its first cell's device, the
    sum sent to every cell of the group (once per distinct device)."""
    axes = _axes(axis)
    out: List[Any] = [None] * len(cells)
    for grp in _groups(env, axes):
        report_collective("all-reduce", len(grp), [cells[c] for c in grp])
        total = cells[grp[0]]
        for c in grp[1:]:
            total = total + cells[c].to(total.device)
        sent: Dict[torch.device, torch.Tensor] = {}
        for c in grp:
            dev = env.cells[c]
            if dev not in sent:
                sent[dev] = total.to(dev)
            out[c] = sent[dev]
    return out


def ppermute(cells: Cells, env: MeshEnv, axis: str, shift: int = 1, *,
             cyclic: bool = True, fill: Optional[Callable] = None) -> Cells:
    """JAX's ``ppermute`` by ``shift`` along ``axis``: the cell at rank i
    receives rank (i - shift)'s tensor on its own device.  Non-cyclic, the
    first ``shift`` ranks receive ``fill(like)`` (zeros by default)."""
    out = []
    moved: Dict[Tuple[int, torch.device], torch.Tensor] = {}
    for c in range(len(cells)):
        grp = env.group(c, axis)
        i = grp.index(c)
        dev = env.cells[c]
        if not cyclic and i - shift < 0:
            like = cells[c]
            out.append(fill(like) if fill is not None
                       else torch.zeros_like(like))
            continue
        src = grp[(i - shift) % len(grp)]
        key = (id(cells[src]), dev)
        if key not in moved:
            moved[key] = cells[src].to(dev)
        out.append(moved[key])
        report_collective("collective-permute", len(grp), [out[-1]])
    return out


def all_gather(cells: Cells, env: MeshEnv, axis, dim: int) -> Cells:
    """JAX's ``all_gather(..., tiled=True)`` over ``axis`` along ``dim``:
    every cell gets its group's tensors concatenated in rank order, once
    per distinct device and group."""
    axes = _axes(axis)
    out: List[Any] = [None] * len(cells)
    for grp in _groups(env, axes):
        made: Dict[torch.device, torch.Tensor] = {}
        for c in grp:
            dev = env.cells[c]
            if dev not in made:
                made[dev] = torch.cat([cells[g].to(dev) for g in grp], dim)
            out[c] = made[dev]
        report_collective("all-gather", len(grp), [out[c] for c in grp],
                          reads=[cells[c] for c in grp], axes=axes)
    return out


def all_to_all(cells: Cells, env: MeshEnv, axis: str, split_dim: int,
               concat_dim: int) -> Cells:
    """JAX's ``all_to_all(..., tiled=True)`` over ``axis``: each cell cuts
    its tensor into n blocks along ``split_dim``; rank j receives block j
    of every rank, concatenated in rank order along ``concat_dim``."""
    out: List[Any] = [None] * len(cells)
    for grp in _groups(env, (axis,)):
        n = len(grp)
        report_collective("all-to-all", n, [cells[c] for c in grp])
        blocks = [cells[c].chunk(n, dim=split_dim) for c in grp]
        for j, c in enumerate(grp):
            dev = env.cells[c]
            out[c] = torch.cat([blocks[i][j].to(dev) for i in range(n)],
                               concat_dim)
    return out


# ---------------------------------------------------------------------------
# activation constraints
# ---------------------------------------------------------------------------

def _divisible(dim: int, env: MeshEnv, axis) -> bool:
    return dim % env.size(axis) == 0


def logical_spec(shape: Sequence[int], logical: Sequence[Optional[str]],
                 env: MeshEnv) -> PartitionSpec:
    """JAX's ``constrain`` rule: 'dp' (batch over the DP axes), 'sp'
    (sequence over model), 'tp' (feature over model), None (replicated);
    a dimension that does not divide falls back to replication."""
    if len(shape) != len(logical):
        raise ValueError(f"{tuple(shape)} against {tuple(logical)}")
    entries = []
    for dim, name in zip(shape, logical):
        if name == "dp" and env.dp_axes and _divisible(dim, env,
                                                       env.dp_axes):
            entries.append(env.dp_axes if len(env.dp_axes) > 1
                           else env.dp_axes[0])
        elif name in ("sp", "tp") and env.tp_axis and _divisible(
                dim, env, env.tp_axis):
            entries.append(env.tp_axis)
        else:
            entries.append(None)
    return P(*entries)


def seq_spec(env: MeshEnv, b: int, ndim: int, seq: bool = True
             ) -> PartitionSpec:
    """The layout of a ``shard_map`` operand: dim 0 (batch ``b``) over the
    DP axes, or replicated where ``b`` does not divide (JAX's
    ``_dp_spec``); dim 1 over ``model`` when ``seq``; the rest whole."""
    dp = env.dp_axes if env.dp_axes and b % env.dp_size == 0 else None
    return P(dp, env.tp_axis if seq else None, *([None] * (ndim - 2)))


def constrain(x, *logical: Optional[str], env: Optional[MeshEnv] = None):
    """JAX's ``constrain``: ``x`` (a whole tensor) laid out over the grid
    by logical names (:func:`logical_spec`), as one piece per cell.  The
    identity without an env (``env`` or the one :func:`set_env`
    installed)."""
    env = env if env is not None else get_env()
    if env is None:
        return x
    return shard(x, logical_spec(x.shape, logical, env), env)


def gather_for_compute(param_tree: Any, env: Optional[MeshEnv] = None,
                       specs: Any = None) -> Any:
    """ZeRO-3 compute-time unsharding of one layer's weights (JAX's
    ``gather_for_compute``): each ≥2-D leaf whose path has no ``expert``
    and no ``router`` is all-gathered whole onto each distinct device of
    the grid, once per device; the other leaves keep their pieces.  The
    leaves are whole tensors (sharded here by :func:`infer_param_specs`)
    or cell lists laid out by ``specs``.  A device that holds the whole
    leaf already gets it with no copy; in training, a leaf's gradient from
    several devices is added in device order.  The identity without an
    env."""
    env = env if env is not None else get_env()
    if env is None:
        return param_tree
    devices = env.distinct_devices

    def go(node, spec, path):
        if isinstance(node, dict):
            return {k: go(v, None if spec is None else spec[k],
                          f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, list):
            cells, spec = node, getattr(node, "spec", None) or spec
        else:
            if spec is None:
                spec = _spec_for(path, tuple(node.shape), env)
            cells = shard(node, spec, env)
        low = path.lower()
        if cells[0].dim() < 2 or "expert" in low or "router" in low:
            return cells
        return gather_whole(cells, spec, env, devices)

    return go(param_tree, specs, "")


def gather_whole(cells: Cells, spec, env: MeshEnv,
                 devices: Optional[Sequence[torch.device]] = None) -> Cells:
    """Every cell's value whole (:func:`unshard`), made once per distinct
    device; in training the pieces reach the other devices through
    :class:`_Fanout`, so each piece's gradient is added in device order."""
    devices = tuple(devices or env.distinct_devices)
    spec = _full_spec(cells.spec if spec is None else spec, cells[0].dim())
    parts = 1
    for e in spec:
        parts *= env.size(_axes(e))
    if _needs_fanout(cells, devices):
        uniq = list({id(t): t for t in cells}.values())
        copies = {id(t): dict(zip(devices, _Fanout.apply(t, devices)))
                  for t in uniq}
        whole = {d: unshard([copies[id(t)][d] for t in cells], spec, env, d)
                 for d in devices}
    else:
        whole = {d: unshard(cells, spec, env, d) for d in devices}
    out = [whole[d] for d in env.cells]
    if parts > 1:
        report_collective("all-gather", parts, out, reads=cells,
                          axes=tuple(a for e in spec for a in _axes(e)))
    return out


def pieces(param_tree: Any, env: MeshEnv) -> Any:
    """Every leaf of ``param_tree`` (a model's parameters, one layer's
    weights, or any subtree with its paths) as :class:`Sharded` pieces by
    its :func:`infer_param_specs` layout, nothing gathered: a ``Sharded``
    leaf passes as it is, a whole tensor is cut (:func:`shard`: views
    where it lies on a cell's device, a copy of its piece on any other
    device).  What a weight-stationary step multiplies by
    (:func:`sharded_dot`); cut once, before a decode loop, so no step
    copies a weight."""
    return _map_with_path(
        lambda path, leaf: leaf if isinstance(leaf, Sharded) else shard(
            leaf, _spec_for(path, tuple(leaf.shape), env), env),
        param_tree)


def _row_axes(env: MeshEnv, rows_split: bool, axes: Tuple[str, ...]
              ) -> Tuple[str, ...]:
    """The axes of ``axes`` (of size > 1) that the token rows are cut over
    too (the DP axes, when ``rows_split``)."""
    return tuple(a for a in (env.dp_axes if rows_split else ())
                 if a in axes and env.size(a) > 1)


def _keep_rows(cells: Cells, env: MeshEnv, axes: Tuple[str, ...]) -> Cells:
    """Each cell's own block of rows (dim 0) of cells that hold the rows
    of its group over ``axes``, in rank order."""
    n = env.size(axes)
    b = cells[0].shape[0] // n
    return cellwise(lambda t, i: t[i * b:(i + 1) * b], cells,
                    [env.axis_index(c, axes) for c in range(env.n_cells)])


def _dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (..., k) @ (k, n) summed and returned in float32, never
    rounded to x's dtype: on the card (and a dry run's fake card) the
    product runs in x's dtype with a float32 result (``torch.mm(...,
    out_dtype=torch.float32)``); on the CPU, which has no such product,
    the operands are widened first (each product of two bf16 is exact in
    float32, so only the order of the sums differs)."""
    if x.dtype == torch.float32:
        return x @ w
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        y = x2.float() @ w.float()
    else:
        y = torch.mm(x2, w, out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def sharded_dot(xs: Cells, w: Any, env: MeshEnv, *, rows_split: bool,
                spec=None, cols=()) -> Cells:
    """``x @ w`` on every cell with the weight ``w`` (in, out) staying in
    its pieces: JAX's product of an activation by a weight sharded by
    ``infer_param_specs``, which moves activations only.  ``xs`` holds one
    activation (..., in) per cell, its rows (dim 0) cut over the DP axes
    when ``rows_split``, whole over the other axes; ``w`` is a
    :class:`Sharded` (or a whole tensor cut by ``spec``).  Returns one
    (..., out) per cell, laid out as ``xs``, equal to ``x @ whole(w)``:

      * the output dim cut over some axes: each cell multiplies by its
        block of columns, and the blocks are all-gathered over those axes
        (column-parallel);
      * the contraction dim cut over some axes: each cell takes its block
        of x's columns, and the partial products, in float32, are added
        over those axes in rank order (:func:`psum`; row-parallel) and
        cast to x's dtype once, so a bf16 grid rounds each output once,
        as one device does.  Where the rows
        are cut over one of those axes too (the train profile: rows and
        ``in`` both over ``data``), the rows are all-gathered over it
        first and each cell keeps its own after the sum;
      * both: both; replicated: the whole weight, no copy.

    Each cell multiplies by its own piece, also where the grid names one
    device several times (cells that share a piece and an activation
    share one product, :func:`cellwise`).

    ``cols`` names the axes over which each cell holds only its rank's
    block of x's columns (a head-split step's heads, in rank order).
    Where the contraction dim is cut over exactly those axes, and the rows
    over none of them, each cell multiplies its block by its own piece and
    nothing is gathered; otherwise the blocks are all-gathered over
    ``cols`` first."""
    if not isinstance(w, Sharded):
        w = shard(w, spec, env)
    k_axes, n_axes = (_axes(e) for e in _full_spec(w.spec, 2))
    rows = _row_axes(env, rows_split, k_axes)
    cols = _axes(cols)
    if cols and (cols != k_axes or rows):
        xs = all_gather(xs, env, cols, -1)
        cols = ()
    if rows:
        xs = all_gather(xs, env, rows, 0)
    nk = env.size(k_axes)

    def part(x, piece, i):
        if nk == 1:
            return x @ piece
        if cols:
            return _dot_f32(x, piece)
        k = piece.shape[0]
        return _dot_f32(x[..., i * k:(i + 1) * k], piece)

    ys = cellwise(part, xs, w, [env.axis_index(c, k_axes)
                                for c in range(env.n_cells)])
    if nk > 1:
        dt = xs[0].dtype
        ys = cellwise(lambda y: y.to(dt), psum(ys, env, k_axes))
    if rows:
        ys = _keep_rows(ys, env, rows)
    if env.size(n_axes) > 1:
        ys = all_gather(ys, env, n_axes, -1)
    return ys


def sharded_take(ids: Cells, table: Any, env: MeshEnv, *, rows_split: bool,
                 spec=None) -> Cells:
    """``table[ids]`` on every cell with the table (V, D) staying in its
    pieces: JAX's vocabulary-parallel embedding.  ``ids`` holds one
    integer tensor per cell, cut over the DP axes when ``rows_split``;
    ``table`` a :class:`Sharded` (or a whole tensor cut by ``spec``).
    Each cell looks up the ids that fall in its block of the vocabulary
    (the others give zeros), and the rows are added over the vocabulary's
    axes in rank order: adding zeros is exact, so each row has the
    table's bits.  A feature dim cut over some axes is all-gathered as
    activation columns; where the ids are cut over one of those axes too,
    they are all-gathered over it first and each cell keeps its own rows.
    Returns one (..., D) per cell."""
    if not isinstance(table, Sharded):
        table = shard(table, spec, env)
    v_axes, d_axes = (_axes(e) for e in _full_spec(table.spec, 2))
    rows = _row_axes(env, rows_split, d_axes)
    if rows:
        ids = all_gather(ids, env, rows, 0)
    nv = env.size(v_axes)

    def look(t, piece, i):
        t = t.long()
        if nv == 1:
            return piece[t]
        n = piece.shape[0]
        local = t - i * n
        got = piece[local.clamp(0, n - 1)]
        mine = ((local >= 0) & (local < n))[..., None]
        return torch.where(mine, got, torch.zeros_like(got))

    xs = cellwise(look, ids, table, [env.axis_index(c, v_axes)
                                     for c in range(env.n_cells)])
    if nv > 1:
        xs = psum(xs, env, v_axes)
    if env.size(d_axes) > 1:
        xs = all_gather(xs, env, d_axes, -1)
    if rows:
        xs = _keep_rows(xs, env, rows)
    return xs


# ---------------------------------------------------------------------------
# parameter sharding rules
# ---------------------------------------------------------------------------

def _spec_for(path: str, shape: Tuple[int, ...], env: MeshEnv
              ) -> PartitionSpec:
    """Infer a PartitionSpec for one parameter from its path + shape
    (``src/repro/distributed/sharding.py:177``, rule for rule)."""
    names: List[Any] = [None] * len(shape)
    dp, tp = env.dp_axes, env.tp_axis
    serve = env.profile == "serve"

    def try_assign(i: int, axis) -> bool:
        if axis and names[i] is None and shape[i] % env.size(axis) == 0:
            names[i] = axis
            return True
        return False

    is_stacked = "stack" in path  # leading layer axis — never sharded
    lead = 1 if is_stacked else 0
    body = list(range(lead, len(shape)))

    if "embed" in path or "unembed" in path:
        # (V, D): vocab over model, feature over data (train) / model only
        # (serve)
        if len(body) == 2:
            try_assign(body[0], tp)
            if not serve:
                try_assign(body[1], dp if len(dp) == 1 else dp[-1])
            return P(*names)

    if "expert" in path and len(body) >= 3:
        # (E, d, f): experts over model (EP), d_ff over data (F-TP) —
        # gate/up shard axis 2, down axis 1
        has_data = "data" in env.axis_names
        try_assign(body[0], tp)
        if has_data:
            if "down" in path:
                try_assign(body[1], "data")
            else:
                try_assign(body[2], "data")
        return P(*names)

    if len(body) == 2:
        a, b = body
        if serve:
            # Megatron TP: shard the non-d_model dim over model
            if "w_down" in path or "proj_in" in path or "wo" in path:
                try_assign(a, tp)  # row-parallel: contraction dim sharded
            else:
                try_assign(b, tp)
        else:
            # 2-D FSDP
            try_assign(a, "data" if "data" in env.axis_names else None)
            try_assign(b, tp)
        return P(*names)

    # 1-D (norm scales, biases) and anything else: replicated
    return P(*names)


def _map_with_path(fn: Callable, tree: Any, path: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list) and tree and not isinstance(
            tree[0], torch.Tensor):
        return [_map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    if isinstance(tree, tuple):
        return tuple(_map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                     for i, v in enumerate(tree))
    return fn(path, tree)


def infer_param_specs(param_tree: Any, env: MeshEnv) -> Any:
    """A PartitionSpec tree parallel to ``param_tree`` (whole tensors, or
    anything with a ``shape``), by ``_spec_for`` on each leaf's path
    ("layers/3/attn/wq") and shape."""
    return _map_with_path(
        lambda path, leaf: _spec_for(path, tuple(leaf.shape), env),
        param_tree)


def param_shardings(param_tree: Any, env: MeshEnv) -> Any:
    """A :class:`NamedSharding` tree parallel to ``param_tree``."""
    return shardings_of(infer_param_specs(param_tree, env), env)


@dataclass(frozen=True)
class NamedSharding:
    """JAX's ``NamedSharding``: a spec on a grid, which cuts a tensor into
    its cells' pieces (:meth:`shard`) and joins them back
    (:meth:`unshard`)."""

    env: MeshEnv
    spec: PartitionSpec

    def shard(self, t: torch.Tensor) -> Cells:
        return shard(t, self.spec, self.env)

    def unshard(self, cells: Cells,
                device: Optional[DeviceLike] = None) -> torch.Tensor:
        return unshard(cells, self.spec, self.env, device)


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def shardings_of(spec_tree: Any, env: MeshEnv) -> Any:
    def go(node):
        if _is_spec(node):
            return NamedSharding(env, node)
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            out = [go(v) for v in node]
            return out if isinstance(node, list) else tuple(out)
        return node

    return go(spec_tree)


def device_put(tree: Any, shardings: Any) -> Any:
    """Every tensor of ``tree`` cut into cell pieces by the parallel
    :class:`NamedSharding` tree (``param_shardings``, ``shardings_of``)."""
    if isinstance(shardings, NamedSharding):
        return shardings.shard(tree)
    if isinstance(tree, dict):
        return {k: device_put(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [device_put(v, s) for v, s in zip(tree, shardings)]
        return out if isinstance(tree, list) else tuple(out)
    return tree


# ---------------------------------------------------------------------------
# batch / cache sharding rules
# ---------------------------------------------------------------------------

def batch_specs(batch_tree: Any, env: MeshEnv, *, seq_sharded: bool = True
                ) -> Any:
    """Input batches: dim 0 = batch over DP, dim 1 = sequence over model
    (when divisible).  Frame/patch embeds follow the same rule."""
    def spec(path, leaf):
        names: List[Any] = [None] * len(leaf.shape)
        if leaf.shape and _divisible(leaf.shape[0], env, env.dp_axes):
            names[0] = env.dp_axes
        if (seq_sharded and len(leaf.shape) >= 2 and env.tp_axis
                and _divisible(leaf.shape[1], env, env.tp_axis)):
            names[1] = env.tp_axis
        return P(*names)

    return _map_with_path(spec, batch_tree)


def cache_specs(cache_tree: Any, env: MeshEnv, batch: int) -> Any:
    """Decode caches (``src/repro/distributed/sharding.py:269``):

      * attention K/V (.../k, .../v, ndim>=4): sequence dim (-3) over
        `model` (split-K flash decode), batch dim over DP;
      * recurrent states (c/n/h/m/tail), ``kpos``, the cross K/V: batch
        dim over DP, rest replicated.

    Batch dims are found by size match against ``batch``."""
    tp = env.tp_axis

    def spec(path, leaf):
        names: List[Any] = [None] * len(leaf.shape)
        last = path.rsplit("/", 1)[-1] if path else ""
        is_kv = last in ("k", "v") and len(leaf.shape) >= 4
        for i, d in enumerate(leaf.shape):
            if d == batch and _divisible(d, env, env.dp_axes):
                names[i] = env.dp_axes
                break
        if is_kv and tp is not None:
            sdim = len(leaf.shape) - 3
            if (names[sdim] is None
                    and _divisible(leaf.shape[sdim], env, tp)):
                names[sdim] = tp
        return P(*names)

    return _map_with_path(spec, cache_tree)
