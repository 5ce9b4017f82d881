"""Analysts' pan-and-zoom queries over the capital's time hierarchy.

The capital's leaves are the finest buckets of a time hierarchy; a
level of width w leaves groups them into buckets [i w, (i + 1) w).  An
analyst who pans and zooms asks for one bucket at a time: a width drawn
from ``widths_leaves``, equally likely, and a bucket of that level
inside the capital.  Every query is covered exactly by stored leaves.

As in ``queries.analyst_queries``, query j of analyst a is element
j * analysts + a of one low-discrepancy stream (additive recurrences
with irrational steps, started at offsets drawn from the seed), so any
stretch of it spreads its widths and positions evenly and two seeds
give the same mix in another order.
"""
from __future__ import annotations

import math
from typing import Iterator, Tuple

from bench.traffic.queries import sub_seed

# fractional parts of the golden ratio and of sqrt(2)
_W_STEP, _AT_STEP = 0.6180339887498949, 0.4142135623730951


def n_leaves(attr_max: float, leaf_units: float) -> int:
    """Leaves of the capital, as ``corpus.leaves`` cuts them."""
    return int(math.ceil(attr_max / leaf_units))


def explore_queries(params: dict, leaves: int, leaf_units: float, seed: int,
                    analyst: int, tag: str = "window"
                    ) -> Iterator[Tuple[float, float]]:
    """Analyst ``analyst``'s ranges [lo, hi), in the order they are sent.

    ``params``: ``analysts`` (how many share the stream) and
    ``widths_leaves`` (the hierarchy's levels, in leaves; none wider
    than the capital's ``leaves``)."""
    n = int(params["analysts"])
    widths = [int(w) for w in params["widths_leaves"]]
    if not widths or min(widths) < 1 or max(widths) > leaves:
        raise ValueError(f"widths {widths} must lie in [1, {leaves}] leaves")
    s = sub_seed(seed, f"explore.{tag}")
    o_w, o_at = (s & 0xFFFF) / 65536.0, ((s >> 16) & 0xFFFF) / 65536.0
    j = analyst
    while True:
        w = widths[min(int(((o_w + j * _W_STEP) % 1.0) * len(widths)),
                       len(widths) - 1)]
        buckets = leaves // w
        i = min(int(((o_at + j * _AT_STEP) % 1.0) * buckets), buckets - 1)
        yield float(i * w * leaf_units), float((i + 1) * w * leaf_units)
        j += n
