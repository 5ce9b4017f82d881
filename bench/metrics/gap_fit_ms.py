"""gap_fit_ms: the program's "train.fit" spans under its "train" spans
(the host issuing a gap's sweeps: the initial counts, the doc index,
the sweep loop), summed, per trained gap, in ms."""
from bench.spans import per_parent_ms


def read(t):
    return per_parent_ms(t, ("train.fit",), "train")
