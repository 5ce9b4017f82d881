"""gap_upload_ms: the program's "train.upload" spans under its "train"
spans (a gap's inputs copied to the card: the DSGS prior, then the
blocked layout), summed, per trained gap, in ms."""
from bench.spans import per_parent_ms


def read(t):
    return per_parent_ms(t, ("train.upload",), "train")
