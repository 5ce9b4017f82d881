"""merge_fetch_ms: the program's "merge.fetch" spans under its "merge"
spans (the LRU gets with the uploads of misses, volatile gap models
among them, and the stacks), summed, per answered query, in ms."""
from bench.spans import per_answer_ms


def read(t):
    return per_answer_ms(t, ("merge.fetch",), "merge")
