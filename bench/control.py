#!/usr/bin/env python3
"""The control of a cell's comparison: the reference put in the
program's place, computed in a lower precision than the configuration
states, at the cell's own size.  It must come out as not correct.

    python3 bench/control.py --workload <cell> --seeds 11 12 13 [--dtype bfloat16]
        [--fault state_unchanged]

For each seed it makes the cell's corpus (and capital), takes the
answers the cell would check (the same windows, or queries of the same
stream with the plan of every leaf inside the range and the two edges as
gaps), computes them with the reference in ``--dtype``, and prints the
numbers the cell compares beside the cell's limits, one JSON line a
seed.  ``--fault state_unchanged`` plants a fault in the reference put
in the program's place instead: the gaps' sampler hands back its
starting assignments (no sweep), which the gapped cell's
``sampler_gap`` must refuse.  The benchmark's own runs never run it.
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
from bench.reference import checks, lda as ref  # noqa: E402
from bench.traffic.corpus import leaves  # noqa: E402
from bench.traffic.queries import (analyst_queries, capital_windows,  # noqa: E402
                                   sub_seed)


def _vb(ctx: Ctx, g, dtype, fault: str = "") -> dict:
    if fault:
        raise ValueError("the capital cell's control plants no fault")
    cfg, wl = ctx.config, ctx.workload
    k, v = cfg["lda"]["n_topics"], cfg["lda"]["vocab_size"]
    windows = capital_windows(wl["window_units"], cfg["corpus"]["attr_max"],
                              ctx.seed)
    prog_seed = sub_seed(ctx.seed, "program")
    picked = []
    for call in range(wl["warmup_windows"] + wl["check_windows"]):
        rg = next(windows)
        if call >= wl["warmup_windows"]:
            picked.append((rg, None,
                           ref.session_lambda0(prog_seed, call, k, v,
                                               ctx.device)))
    return checks.vb_windows(g, picked, cfg["lda"], ctx.device, dtype=dtype,
                             answers_from_reference=True)


def _gs(ctx: Ctx, g, dtype, fault: str = "") -> dict:
    cfg, wl = ctx.config, ctx.workload
    lda_cfg, dev = cfg["lda"], ctx.device
    ctl_cfg = dict(lda_cfg, gibbs_sweeps=0) \
        if fault == "state_unchanged" else lda_cfg
    leaf = cfg["capital"]["leaf_units"]
    all_leaves = [(lo, hi) for lo, hi in leaves(cfg["corpus"]["attr_max"],
                                                leaf)
                  if g.docs_in(lo, hi)[1] > g.docs_in(lo, hi)[0]]
    prior = torch.zeros((lda_cfg["n_topics"], lda_cfg["vocab_size"]),
                        dtype=torch.float64, device=dev)
    for lo, hi in all_leaves:
        prior += checks.counts(g, *g.tokens_in(lo, hi), dev)
    gen = torch.Generator(device=dev).manual_seed(sub_seed(ctx.seed,
                                                           "control"))
    answers = []
    stream = analyst_queries(wl, cfg["corpus"]["attr_max"], ctx.seed, 0,
                             "window")
    for _ in range(wl["check_answers"] + 1):
        lo, hi = next(stream)
        fetched = [(a, b) for a, b in all_leaves if lo <= a and b <= hi]
        gaps = [(lo, fetched[0][0]), (fetched[-1][1], hi)]
        beta = checks.control_gs_answer(g, (lo, hi), fetched, gaps, ctl_cfg,
                                        prior, gen, dev, dtype)
        answers.append({"sigma": (lo, hi), "beta": beta, "fetched": fetched,
                        "gaps": gaps})
    rgen = torch.Generator(device=dev).manual_seed(sub_seed(ctx.seed,
                                                            "reference"))
    return checks.gs_answers(g, answers, lda_cfg, prior, rgen, dev)


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--fault", default="", choices=("", "state_unchanged"))
    a = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[a.workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    workload = json.loads(
        (ROOT / "bench" / "workloads" / f"{a.workload}.json").read_text())
    if device is None:
        if not torch.cuda.is_available():
            print("the control runs on the card", file=sys.stderr)
            return 2
        device = "cuda:0"
    dtype = getattr(torch, a.dtype)
    run = {"train_range": _vb, "service_submit": _gs}[workload["entry"]]
    for seed in a.seeds:
        t0 = time.perf_counter()
        ctx = Ctx(name=a.workload, config=config, workload=workload,
                  seed=seed, seconds=0.0, trace=False,
                  device=torch.device(device), t_start=t0)
        numbers = run(ctx, generate(ctx), dtype, a.fault)
        print(json.dumps({"seed": seed, "dtype": a.dtype, "fault": a.fault,
                          "numbers": numbers, "limits": workload["limits"],
                          "fails": sorted(n for n, lim in
                                          workload["limits"].items()
                                          if not numbers.get(n, np.inf)
                                          <= lim),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
