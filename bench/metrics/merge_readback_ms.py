"""merge_readback_ms: the program's "merge.readback" and
"merge.finish" spans under its "merge" spans — β copied back to the
host (waiting for the launch) and finished in numpy — summed, per
answered query, in ms."""
from bench.spans import per_answer_ms


def read(t):
    return per_answer_ms(t, ("merge.readback", "merge.finish"), "merge")
