"""Dry run: cost one step of every (arch × shape × grid) cell on fake cards.

The port of ``src/repro/launch/dryrun.py``.  JAX lowers and compiles each
cell for a placeholder TPU mesh and reads XLA's memory analysis and the
optimised HLO.  The port runs the cell's step itself, eagerly, under
``FakeTensorMode`` (shapes and dtypes, no storage: nothing is allocated,
no kernel is launched) with ``launch.cost.OpCounter`` counting every op
on every fake card.  For each cell it:

  1. builds the step and its inputs (``launch/specs.py``: the port's own
     entry points, weights sharded by its own rules) on the grid of
     ``launch/mesh.py``;
  2. runs the step once with the counter on;
  3. writes one JSON record per cell under ``--out``:

     * ``bytes_per_device`` — ``argument`` (the inputs' storages),
       ``output`` (the outputs' storages), ``peak`` (the most bytes live
       at once during the step) and ``temp`` (peak − argument), each on
       the busiest card (the one with the highest peak), and each of
       the first three for every card in grid order (``*_by_device``);
     * ``op_analysis`` — ``flops``, ``hbm_bytes``,
       ``hbm_bytes_kernel_interior`` and ``collective_wire_bytes``, each
       the most of any card; ``collective_counts`` and
       ``collective_bytes_by_kind`` of the card with the most wire bytes;
       ``kernel_launches``, ``kernel_flops`` and ``kernel_bytes`` (the
       kernels' shape-only launches and their ``cost(...)``, all cards)
       and ``copy_bytes_in`` (the most bytes a card received through the
       single controller's copies);
     * ``roofline`` — seconds per step of one card: ``compute_s`` (FLOPs
       at ``PEAK_FLOPS``), ``memory_s`` (HBM bytes at ``HBM_BW``),
       ``collective_s`` (wire bytes at ``LINK_BW``),
       ``memory_kernelized_s`` (without the kernel-interior bytes), and
       the ``dominant`` term of the first three;
     * ``fits`` — whether the peak fits ``HBM_BYTES``; ``trace_s``, the
       seconds the dry run took;
     * ``weight_gathers`` — for each weight leaf whose pieces an
       all-gather read, "path over axes" (a layer's index as ``*``) and
       how many all-gathers read it (:func:`weight_gathers`).  A serving
       step reads the weights it is given; a training step of a bf16
       model gathers the copies it casts, which name no leaf.

The card is one H100 SXM at its published peaks (700 W): 989 TFLOP/s of
dense bf16, 3.35 TB/s of HBM, and 450 GB/s each way of NVLink 4 (the
data sheet's 900 GB/s total).  These are predictions, not measurements.

Every failure is printed and counted, and the run exits with 1 if there
was any: a failure here is a fault of the port, not of the cell.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh card,node --out experiments/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ALL_SHAPES, ARCHS, get_arch, get_shape
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed.sharding import MeshEnv
from repro_torch.kernels.common import PEAK_BF16_TC_FLOPS, PEAK_BYTES_S
from repro_torch.launch.cost import OpCounter, storage_bytes
from repro_torch.launch.mesh import make_env
from repro_torch.launch.specs import make_spec
from repro_torch.models.model import Model

# one H100 SXM's published peaks at 700 W, per card: dense bf16 on the
# tensor cores and HBM bytes/s (``kernels.common``), NVLink 4 bytes/s
# each way, and its memory
CARD = "NVIDIA H100 80GB HBM3, published peaks at 700 W"
PEAK_FLOPS = PEAK_BF16_TC_FLOPS
HBM_BW = PEAK_BYTES_S
LINK_BW = 450e9
HBM_BYTES = 80e9


def _leaf_storages(tree: Any, path: str = "") -> Dict[int, str]:
    """Each storage of a parameter tree's tensors (whole leaves or their
    ``Sharded`` pieces) and its leaf's path, with a layer's index as
    ``*`` ("layers/*/attn/wq")."""
    out: Dict[int, str] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_leaf_storages(v, f"{path}/{k}" if path else k))
    elif isinstance(tree, list) and tree and not isinstance(tree[0],
                                                            torch.Tensor):
        for v in tree:
            out.update(_leaf_storages(v, f"{path}/*"))
    else:
        for t in ([tree] if isinstance(tree, torch.Tensor) else tree):
            out[t.untyped_storage()._cdata] = path
    return out


def weight_gathers(counter: OpCounter, params: Any) -> Dict[str, int]:
    """The all-gathers of ``counter`` that read a piece of a leaf of
    ``params``: for each "path over axes", how many (the layers' summed)."""
    paths = _leaf_storages(params)
    out: Dict[str, int] = {}
    for keys, axes in counter.gathered:
        for path in sorted({paths[k] for k in keys if k in paths}):
            key = f"{path} over {'+'.join(axes)}"
            out[key] = out.get(key, 0) + 1
    return out


def stray_decode_gathers(rec: Dict[str, Any]) -> Dict[str, int]:
    """The entries of a record's ``weight_gathers`` that a weight-stationary
    decode step makes none of: every one but the leaves of
    ``Model.DECODE_GATHERED`` and the head's table (``embed`` or ``unembed``)
    gathered over axes other than its vocabulary's ``model`` (JAX's
    ``_logits`` gathers its feature dim)."""
    out = {}
    for key, n in rec["weight_gathers"].items():
        path, axes = key.split(" over ")
        head = path in ("embed", "unembed") and "model" not in axes.split("+")
        if not head and path.rsplit("/", 1)[-1] not in \
                Model.DECODE_GATHERED:
            out[key] = n
    return out


def run_cell(cfg: ArchConfig, shape: ShapeConfig, env: MeshEnv,
             mesh_name: str) -> Dict[str, Any]:
    """The record of one cell (module docstring)."""
    t0 = time.perf_counter()
    with FakeTensorMode():
        spec = make_spec(cfg, shape, env)
        static = dict(spec.static)
        with OpCounter() as c:
            args = c.track(spec.args)
            if static["mode"] == "train":
                out = spec.step(*spec.args)
            else:
                with torch.no_grad():
                    out = spec.step(*spec.args)
            outs = storage_bytes(out)
            del out
        gathers = weight_gathers(c, spec.args[0])
        del spec
    trace_s = time.perf_counter() - t0
    busy = c.busiest()
    d = c.devices[busy]
    wire_dev = c.devices[c.busiest("collective_wire_bytes")]
    op = {
        "flops": c.max("flops"),
        "hbm_bytes_kernel_interior": c.max("hbm_bytes_kernel_interior"),
        "hbm_bytes": c.max("hbm_bytes"),
        "collective_wire_bytes": c.max("collective_wire_bytes"),
        "collective_counts": dict(wire_dev.collective_counts),
        "collective_bytes_by_kind": dict(wire_dev.collective_bytes_by_kind),
        "kernel_launches": c.per_kernel("kernel_launches"),
        "kernel_flops": c.per_kernel("kernel_flops"),
        "kernel_bytes": c.per_kernel("kernel_bytes"),
        "copy_bytes_in": c.max("copy_bytes_in"),
    }
    kernelized = max(v.hbm_bytes - v.hbm_bytes_kernel_interior
                     for v in c.devices.values())
    roof = {
        "compute_s": op["flops"] / PEAK_FLOPS,
        "memory_s": op["hbm_bytes"] / HBM_BW,
        "collective_s": op["collective_wire_bytes"] / LINK_BW,
        "memory_kernelized_s": kernelized / HBM_BW,
    }
    roof["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                           key=roof.get)
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": mesh_name,
        "n_devices": env.n_cells,
        "mode": static["mode"],
        "optimizer": static.get("optimizer"),
        "card": CARD,
        "trace_s": round(trace_s, 2),
        "bytes_per_device": {
            "argument": int(args.get(busy, 0)),
            "output": int(outs.get(busy, 0)),
            "temp": int(d.peak_bytes - args.get(busy, 0)),
            "peak": int(d.peak_bytes),
            "argument_by_device": [int(args.get(x, 0)) for x in env.cells],
            "output_by_device": [int(outs.get(x, 0)) for x in env.cells],
            "peak_by_device": [int(c.dev(x).peak_bytes) for x in env.cells],
        },
        "op_analysis": op,
        "roofline": roof,
        "fits": d.peak_bytes <= HBM_BYTES,
        "weight_gathers": gathers,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="card,node")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = ([s.name for s in ALL_SHAPES] if args.shape == "all"
              else args.shape.split(","))
    meshes = args.mesh.split(",")
    os.makedirs(args.out, exist_ok=True)

    n_ok = n_skip = n_fail = 0
    for mesh_name in meshes:
        env = make_env(mesh_name)
        for arch in archs:
            cfg = get_arch(arch)
            for shape_name in shapes:
                shape = get_shape(shape_name)
                tag = f"{arch}__{shape_name}__{mesh_name}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    n_ok += 1
                    continue
                if not cfg.supports_shape(shape):
                    print(f"SKIP {tag} (full attention at 500k)")
                    n_skip += 1
                    continue
                try:
                    rec = run_cell(cfg, shape, env, mesh_name)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    r, m = rec["roofline"], rec["bytes_per_device"]
                    print(f"OK   {tag}: {rec['trace_s']:.1f}s peak "
                          f"{m['peak'] / 1e9:.2f} GB"
                          f"{'' if rec['fits'] else ' (does not fit)'} "
                          f"compute {r['compute_s'] * 1e3:.2f}ms memory "
                          f"{r['memory_s'] * 1e3:.2f}ms coll "
                          f"{r['collective_s'] * 1e3:.2f}ms -> "
                          f"{r['dominant']}", flush=True)
                    n_ok += 1
                except Exception:
                    print(f"FAIL {tag}\n{traceback.format_exc()}",
                          flush=True)
                    n_fail += 1
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
