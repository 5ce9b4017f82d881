"""window_upload_ms: the program's "train.upload" spans under its
"train" spans (a capital window's doc-term matrix copied to the card),
summed, per trained window, in ms."""
from bench.spans import per_parent_ms


def read(t):
    return per_parent_ms(t, ("train.upload",), "train")
