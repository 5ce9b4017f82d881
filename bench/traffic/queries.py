"""Analysts' query streams and the capital cell's window stream.

Every stream is a low-discrepancy sequence (additive recurrences with
irrational steps) started at offsets drawn from the seed.  Any stretch
of it spreads its widths and edge positions evenly over their ranges,
so two seeds give the same mix of sizes in another order and the work
a window holds barely depends on the seed.
"""
from __future__ import annotations

import hashlib
from typing import Iterator, Tuple

# fractional parts of the golden ratio and of sqrt(2), sqrt(3)
_STEPS = (0.6180339887498949, 0.4142135623730951, 0.7320508075688772)


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose, derived from the run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _offsets(seed: int, tag: str, n: int):
    s = sub_seed(seed, tag)
    return [((s >> (16 * i)) & 0xFFFF) / 65536.0 for i in range(n)]


def analyst_queries(params: dict, attr_max: float, seed: int,
                    analyst: int, tag: str = "window"
                    ) -> Iterator[Tuple[float, float]]:
    """Analyst ``analyst``'s ranges [lo, hi), in the order they are sent.

    ``params``: ``analysts`` (how many share the stream),
    ``width_min``/``width_max`` (attribute units).  Query j of analyst
    a is element j * analysts + a of one stream, so the analysts
    together walk the stream in step.  The width is spread uniformly
    over [width_min, width_max] and the start over [0, attr_max -
    width], so both ends fall anywhere inside a leaf.
    """
    n = int(params["analysts"])
    w0, w1 = float(params["width_min"]), float(params["width_max"])
    o_w, o_lo = _offsets(seed, tag, 2)
    j = analyst
    while True:
        fw = (o_w + j * _STEPS[0]) % 1.0
        fl = (o_lo + j * _STEPS[1]) % 1.0
        width = w0 + (w1 - w0) * fw
        lo = fl * (attr_max - width)
        yield lo, lo + width
        j += n


def capital_windows(window_units: float, attr_max: float, seed: int
                    ) -> Iterator[Tuple[float, float]]:
    """Consecutive windows of ``window_units`` from a window picked by
    the seed, wrapping at the end of the attribute range."""
    n = int(attr_max // window_units)
    i = sub_seed(seed, "capital") % n
    while True:
        lo = i * window_units
        yield lo, lo + window_units
        i = (i + 1) % n
