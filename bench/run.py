#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the root of the
checkout: the cell's entry there names its configuration
(``bench/configs/<config>.json``, through the configuration's ``file``)
and its own file ``bench/workloads/<cell>.json``, whose ``entry`` names
the driver in ``bench/entries/``.  With ``--trace 1`` each per-layer
metric of the cell is read by ``bench/metrics/<metric>.py``.

The run needs as many CUDA cards as the cell asks for, and exits with
code 2, printing no result, without them.  It prints progress and each
number compared beside its limit on standard error, and one JSON line
on standard output, last.  It exits with code 3, printing no result, if
JAX, the JAX package or the old benchmarks were loaded in its process.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths
_CACHES = {"TRITON_CACHE_DIR": "triton",
           "TORCH_EXTENSIONS_DIR": "torch_extensions",
           "CUDA_CACHE_PATH": "cuda"}
for _var, _sub in _CACHES.items():
    os.environ[_var] = str(ROOT / "build" / "bench_cache" / _sub)
os.environ["USE_FLAX"] = "0"
# one intra-op CPU thread: the program's host work runs on its own few
# threads (the service's workers, the sender), and a pool of spinning
# OpenMP threads beside them made runs both slower and less steady
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_reader(name: str):
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _power_limit() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None, device=None) -> int:
    """Run the cell; ``device`` is for the CPU tests alone (the command
    line always asks for the card)."""
    args = parse(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    workload = json.loads(
        (ROOT / "bench" / "workloads" / f"{cell['name']}.json").read_text())

    import torch
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            print(f"the cell needs {cell['chips']} CUDA card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda:0"
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from bench.entries.common import Ctx
    ctx = Ctx(name=cell["name"], config=config, workload=workload,
              seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              device=device, t_start=T_START)
    entry = importlib.import_module(f"bench.entries.{workload['entry']}")
    out = entry.run(ctx)

    metrics = {}
    breakdown = None
    if not args.trace:
        for m in bench["end_to_end"]:
            if applies(m, cell["name"]):
                val = out.setup_s if m["name"] == "setup_s" \
                    else out.e2e.get(m["name"])
                if val is not None:
                    metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if applies(m, cell["name"]):
                val = load_reader(m["name"])(out.trace)
                if val is not None:
                    metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        dt = out.trace.device
        if dt is not None:
            from bench.devtrace.window import idle_by_host_activity
            breakdown = {"device_ops": dt.top_ops(10),
                         "idle_gaps": idle_by_host_activity(
                             dt, out.trace.spans, 10)}

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu",
                "count": cell["chips"],
                "memory_peak_bytes": out.memory_peak_bytes}
    if device.type == "cuda":
        dev_info["power"] = _power_limit()
    if args.trace and out.trace.device is not None:
        dev_info["busy_s"] = out.trace.device.busy_s
        dev_info["window_s"] = out.trace.device.window_s

    found = forbidden_modules()
    if found:
        print(f"refused: the run loaded {found}", file=sys.stderr)
        return 3

    correct = (out.failed == 0 and out.attempted > 0
               and all(val <= lim for val, lim in out.checks.values()))
    for name, (val, lim) in out.checks.items():
        print(f"check {name}: {val!r} (limit {lim!r})", file=sys.stderr)
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": val, "limit": lim}
                        for name, (val, lim) in out.checks.items()}
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
