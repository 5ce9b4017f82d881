"""What every entry shares: the run's context, its outcome, and the
pieces that hand generated inputs to the program."""
from __future__ import annotations

import gc
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from bench.costs.kernels import Work
from bench.devtrace.window import DeviceTrace
from bench.traffic.corpus import GenCorpus, make_corpus
from bench.traffic.queries import sub_seed


@dataclass
class Ctx:
    """One run: the cell's files as read, the command line, the device."""

    name: str
    config: dict
    workload: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float

    def log(self, *msg: Any) -> None:
        print(f"[{time.perf_counter() - self.t_start:8.2f}s]", *msg,
              file=sys.stderr, flush=True)


@dataclass
class TraceCtx:
    """What the per-layer readers read in a ``--trace 1`` run.

    device    the card's operations over the traced window (None off it)
    spans     the program's spans that started inside the window
    latencies client-side seconds from send to answer, every answered
              query of the window
    work      model operations the window's answers required, by kind
              ("merge", "gibbs", "vb_estep"), as frozen work counts
    counters  the program's counters over the window (differences)
    answered  queries answered (or windows trained) in the window
    """

    device: Optional[DeviceTrace]
    spans: list
    latencies: List[float] = field(default_factory=list)
    work: Dict[str, List[Work]] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    answered: int = 0


@dataclass
class Outcome:
    setup_s: float
    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Tuple[float, float]]
    memory_peak_bytes: int
    trace: Optional[TraceCtx] = None


def generate(ctx: Ctx) -> GenCorpus:
    c = ctx.config["corpus"]
    return make_corpus(
        c["n_docs"], c["vocab_size"], c["n_topics"],
        mean_doc_len=c["mean_doc_len"], alpha=c["alpha"], eta=c["eta"],
        attr_max=c["attr_max"], seed=sub_seed(ctx.seed, "corpus"),
        device=ctx.device)


def program_corpus(g: GenCorpus):
    from repro_torch.data.corpus import Corpus
    return Corpus(tokens=g.tokens, doc_ids=g.doc_ids, doc_offsets=g.offsets,
                  attr=g.attr, vocab_size=g.vocab_size)


def lda_config(ctx: Ctx):
    from repro_torch.configs.lda_default import LDAConfig
    return LDAConfig(**ctx.config["lda"])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        torch.cuda.synchronize()
        return int(torch.cuda.max_memory_allocated())
    return 0


def release(device: torch.device) -> None:
    """Free what the program held before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Tuple[float, float]]:
    """Each number beside its limit, by the limits' names (a number the
    comparison could not produce reads as the largest float)."""
    out = {}
    for name, lim in limits.items():
        val = float(numbers.get(name, float("inf")))
        out[name] = (val if math.isfinite(val) else sys.float_info.max,
                     float(lim))
    return out
