#!/usr/bin/env python3
"""The control of the explore cells' comparison: the reference put in
the program's place, its merge computed in a lower precision than the
configuration states (float32), at the cell's own size.  It must come
out as not correct.

    python3 bench/control_explore.py --workload <cell> --seeds 11 12 13 [--dtype bfloat16]

For each seed it makes the cell's corpus, takes queries of the cell's
own stream (the first query of ``check_answers`` analysts and one of the
widest level), answers each with the leaves that tile it merged by
``reference/vb_merge.py::control_answer`` in ``--dtype``, and prints the
numbers the cell compares beside the cell's limits, one JSON line a
seed.  The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench.entries.common import Ctx, generate  # noqa: E402
from bench.reference import vb_merge  # noqa: E402
from bench.traffic.explore import explore_queries, n_leaves  # noqa: E402


def answers(ctx: Ctx, g, dtype) -> list:
    cfg, wl = ctx.config, ctx.workload
    leaf = cfg["capital"]["leaf_units"]
    count = n_leaves(cfg["corpus"]["attr_max"], leaf)
    widest = max(wl["widths_leaves"]) * leaf
    sigmas = [next(explore_queries(wl, count, leaf, ctx.seed, a))
              for a in range(wl["check_answers"])]
    sigmas.append(next(s for s in explore_queries(wl, count, leaf, ctx.seed,
                                                  0)
                       if s[1] - s[0] == widest))
    out = []
    for lo, hi in sigmas:
        fetched = [(a, a + leaf) for a in np.arange(lo, hi, leaf).tolist()]
        out.append({"sigma": (lo, hi), "fetched": fetched,
                    "beta": vb_merge.control_answer(
                        g, fetched, cfg["lda"]["eta"], ctx.device, dtype)})
    return out


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--dtype", default="bfloat16")
    a = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[a.workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    workload = json.loads(
        (ROOT / "bench" / "workloads" / f"{a.workload}.json").read_text())
    if workload["entry"] != "service_explore":
        print(f"{a.workload} is not an explore cell", file=sys.stderr)
        return 2
    if device is None:
        if not torch.cuda.is_available():
            print("the control runs on the card", file=sys.stderr)
            return 2
        device = "cuda:0"
    dtype = getattr(torch, a.dtype)
    for seed in a.seeds:
        t0 = time.perf_counter()
        ctx = Ctx(name=a.workload, config=config, workload=workload,
                  seed=seed, seconds=0.0, trace=False,
                  device=torch.device(device), t_start=t0)
        g = generate(ctx)
        numbers = vb_merge.vb_answers(g, answers(ctx, g, dtype),
                                      config["lda"]["eta"], ctx.device)
        limits = workload["limits"]
        print(json.dumps({"seed": seed, "dtype": a.dtype, "numbers": numbers,
                          "limits": limits,
                          "fails": sorted(n for n, lim in limits.items()
                                          if not numbers.get(n, np.inf)
                                          <= lim),
                          "seconds": time.perf_counter() - t0}), flush=True)
        del g
    return 0


if __name__ == "__main__":
    sys.exit(main())
