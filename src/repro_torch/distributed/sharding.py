"""Mesh environment of the port: a 2-D grid of devices, axes ("data", "model").

The part of ``repro.distributed.sharding`` that MLego uses.  JAX's
``MeshEnv`` wraps a ``jax.sharding.Mesh`` and its collectives run inside
``shard_map``; the vocab-sharded merge there is *single-controller*: one
process drives every local device.  The port keeps that shape.  A
``MeshEnv`` is a grid of ``torch.device``s; a sharded function holds one
tensor per grid cell, runs each cell's work on that cell's device, and
reduces across cells with :func:`all_reduce`, which adds the cells'
tensors in grid order on the first cell's device and sends the sum back.
So the port needs no ``torch.distributed`` and no process group, and a
reduction gives the same bits on every run.

A grid may name one device several times: a (1, 4) grid of ``cuda:0``
holds four vocabulary slices on one card, and a (1, 8) grid of ``"cpu"``
stands in for the eight host devices the JAX tests force.

The LM sharding rules of the JAX module (``constrain``,
``gather_for_compute``, ``infer_param_specs``, ``param_shardings``,
``batch_specs``, ``cache_specs``, ``shardings_of``) belong to LM training
and serving on several devices.  The port trains and serves on one
device (``train/*``, ``launch/{train,serve}.py``); those rules wait for
ROADMAP.md Queue 1 item 6.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels.common import resolve_device

DeviceLike = Union[str, torch.device]


@dataclass(frozen=True)
class MeshEnv:
    """``devices[d][m]`` is the device of data rank d, model shard m."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    def __post_init__(self):
        grid = tuple(tuple(resolve_device(d) for d in row)
                     for row in self.devices)
        if not grid or not grid[0] or len({len(r) for r in grid}) != 1:
            raise ValueError(f"a mesh is a non-empty rectangular grid of "
                             f"devices, got {self.devices!r}")
        object.__setattr__(self, "devices", grid)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data", "model")

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return ("data",)

    @property
    def tp_axis(self) -> Optional[str]:
        return "model"

    def size(self, axis) -> int:
        if axis is None:
            return 1
        if isinstance(axis, (tuple, list)):
            out = 1
            for a in axis:
                out *= self.size(a)
            return out
        if axis == "data":
            return len(self.devices)
        if axis == "model":
            return len(self.devices[0])
        raise ValueError(f"unknown mesh axis {axis!r}")

    @property
    def dp_size(self) -> int:
        return self.size(self.dp_axes)

    @property
    def tp_size(self) -> int:
        return self.size(self.tp_axis)

    @property
    def first(self) -> torch.device:
        """The device of cell (0, 0): reductions land here."""
        return self.devices[0][0]


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


def single_device_env(device: Optional[DeviceLike] = None) -> MeshEnv:
    """A (1, 1) grid over ``device`` (the current card by default)."""
    return MeshEnv(((resolve_device(device),),))


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


def all_reduce(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Sum one tensor per cell; every cell gets the sum on its device.

    The sum is taken in the order given, on the first tensor's device,
    then copied to each cell's device (a copy onto the same device is
    no copy): the same bits on every run, where a ``psum`` may add in
    any order.  Returns one tensor per input, in input order."""
    total = tensors[0]
    for t in tensors[1:]:
        total = total + t.to(total.device)
    return [total if t.device == total.device else total.to(t.device)
            for t in tensors]
