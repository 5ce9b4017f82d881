"""gap_readback_ms: the program's "train.readback" spans under its
"train" spans (a gap's counts copied back to the host, which waits for
the card first), summed, per trained gap, in ms."""
from bench.spans import per_parent_ms


def read(t):
    return per_parent_ms(t, ("train.readback",), "train")
