"""window_layout_ms: the program's "train.layout" spans under its
"train" spans (a capital window's dense doc-term matrix built on the
host), summed, per trained window, in ms."""
from bench.spans import per_parent_ms


def read(t):
    return per_parent_ms(t, ("train.layout",), "train")
