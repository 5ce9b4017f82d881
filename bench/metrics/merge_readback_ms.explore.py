"""merge_readback_ms.explore: the program's "merge.readback" spans under
its "merge" spans alone (the answers' beta copied back to the host,
which waits for the launch first), summed, per answered query, in ms."""
from bench.spans import per_answer_ms


def read(t):
    return per_answer_ms(t, ("merge.readback",), "merge")
