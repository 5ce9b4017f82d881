"""Phase 13's grid steps for two checkouts of this repository, in turns.

Usage, on a machine with a CUDA card:

    python3 tools/grid_ab.py DIR_A DIR_B [--mode train|serve] [--rounds N]

Runs DIR_A, DIR_B, DIR_B, DIR_A (``--rounds`` times, 1 by default), each
in a fresh process that imports ``repro_torch`` from that checkout's
``src/``, and prints the card's name and power limit, then one line a
run:

  * ``train`` (``chip_smoke.py`` phase 13 (f)'s step): qwen3-1.7b's
    widths at 8 layers, bf16, AdamW, 2 x 4,096 tokens, on one device and
    on a (2, 2) grid naming the card four times; a warm step, then 3
    timed steps: seconds a step, the garbage collector's passes, peak
    memory allocated;
  * ``serve`` (phase 13 (a)'s shape): qwen3-1.7b at full width, bf16, a
    2 x 4,096-token prompt and 32 greedy steps on a (1, 4) grid of the
    card, then on one device, then on the grid again: prefill seconds and
    decode milliseconds a step.

The grid's times are host-bound and swing by tens of percent from one
call to the next, so compare two versions only within one call.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import os
import subprocess
import sys
import time


def run_train(torch, env_cls) -> str:
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import make_batch
    from repro_torch.models.model import build_model
    from repro_torch.train import OptimizerConfig, Trainer

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_arch("qwen3-1.7b"), n_layers=8)
    model = build_model(cfg)
    opt = OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=2)
    batch = make_batch(cfg, 2, 4096, 0, 0, device=dev)
    out = []
    for name, env in (("one", None), ("grid", env_cls([[dev] * 2] * 2))):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(model, opt, seed=0, device=dev, env=env)
        state = tr.init_state()
        passes = 0
        for i in range(4):                      # the first step warms up
            if i == 1:
                torch.cuda.synchronize()
                passes = sum(s["collections"] for s in gc.get_stats())
                t0 = time.perf_counter()
            p, o, s, _ = tr._step_fn(state.params, state.opt_state,
                                     state.step, batch)
            state = dataclasses.replace(state, params=p, opt_state=o, step=s)
            del p, o, s
        torch.cuda.synchronize()
        secs = (time.perf_counter() - t0) / 3
        passes = sum(s["collections"] for s in gc.get_stats()) - passes
        out.append(f"{name} {secs:.4f} s a step, {passes} collector passes, "
                   f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del tr, state
    return " | ".join(out)


def run_serve(torch, env_cls) -> str:
    from repro_torch.configs import get_arch
    from repro_torch.data.lm import make_batch
    from repro_torch.launch.serve import generate
    from repro_torch.models.model import build_model

    dev = torch.device("cuda", 0)
    cfg = get_arch("qwen3-1.7b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        cast=True)
    batch = {"tokens": make_batch(cfg, 2, 4096, 0, 0, device=dev)["tokens"]}
    grid = env_cls([[dev] * 4])
    generate(model, params, batch, steps=4, cache_len=4160, env=grid)
    out = []
    for name, env in (("grid", grid), ("one", None), ("grid", grid)):
        st: dict = {}
        generate(model, params, batch, steps=32, cache_len=4160, stats=st,
                 env=env)
        out.append(f"{name} prefill {st['prefill_s']:.4f} s, decode "
                   f"{st['decode_s'] / 32 * 1e3:.2f} ms a step")
    return " | ".join(out)


def child(root: str, mode: str) -> int:
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    from repro_torch.distributed.sharding import MeshEnv

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    line = (run_train if mode == "train" else run_serve)(torch, MeshEnv)
    print(f"{os.path.basename(os.path.abspath(root))} | {line}", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("dirs", nargs="*")
    ap.add_argument("--mode", choices=("train", "serve"), default="train")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--child", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child, args.mode)
    if len(args.dirs) != 2:
        ap.error("give two checkouts: DIR_A DIR_B")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    a, b = args.dirs
    for _ in range(args.rounds):
        for root in (a, b, b, a):
            rc = subprocess.run([sys.executable, __file__, "--child", root,
                                 "--mode", args.mode]).returncode
            if rc:
                return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
