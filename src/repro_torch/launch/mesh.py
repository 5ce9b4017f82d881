"""The grids a dry run costs a step on: fake cards, shapes only.

The port of ``src/repro/launch/mesh.py``.  A dry run
(``launch/dryrun.py``) builds every tensor under ``FakeTensorMode``
(shapes and dtypes, no storage), so a grid of cards needs no card:

  * ``"node"`` — one host's eight H100s as a (2, 4) grid over
    ("data", "model"), the grid of ``tests/test_torch_grid.py``;
  * ``"card"`` — one H100, a (1, 1) grid.

Each fake card is a ``meta`` device, ``meta:0`` to ``meta:7``, not
``cuda:i``: the autograd engine asks the CUDA runtime for the stream of
every device a differentiable op's output lies on, which a CPU build of
PyTorch cannot answer (the process aborts) and a host with one card
refuses for ``cuda:1`` and up, so a training step on fake ``cuda``
devices cannot be costed on the hosts that need it.  The kernel wrappers
take their shape-only route for any fake tensor off the CPU, so the
port's code runs on these devices as it does on cards, and a real
``MeshEnv`` still resolves ``cuda`` devices as before.

JAX's production meshes, (16, 16) over ("data", "model") and
(2, 16, 16) over ("pod", "data", "model"), have no counterpart: the
port is single-controller with no ``torch.distributed`` (one process
drives every cell, so it never drives more than one host's cards), and
c10 keeps a device index in an ``int8``, so a grid cannot name more than
128 devices (``torch.device("cuda", 128)`` reads back as ``cuda:-128``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.distributed.sharding import MeshEnv

FAKE_DEVICE = "meta"
MESHES: Dict[str, Tuple[int, int]] = {"card": (1, 1), "node": (2, 4)}


def make_env(mesh: str = "node", profile: str = "train") -> MeshEnv:
    """The (data, model) grid ``mesh`` ("card" or "node") over fake cards
    ``meta:0``, ``meta:1``, ... in rank order, with the weight rules of
    ``profile`` ("train" | "serve")."""
    if mesh not in MESHES:
        raise ValueError(f"unknown mesh {mesh!r}; known: {sorted(MESHES)}")
    d, m = MESHES[mesh]
    return MeshEnv(tuple(tuple(torch.device(FAKE_DEVICE, i * m + j)
                               for j in range(m)) for i in range(d)),
                   profile=profile)
