"""gap_layout_ms: the program's "train.layout" spans under its "train"
spans (the host's layout of a gap's tokens: the doc-order check, the
sort when needed, the blocked layout), summed, per trained gap, in ms."""
from bench.spans import per_parent_ms


def read(t):
    return per_parent_ms(t, ("train.layout",), "train")
