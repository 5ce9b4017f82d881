"""merge_fetch_ms.explore: the program's "merge.fetch" spans under its
"merge" spans (the LRU gets and, for a batch, the pointer table built
and uploaded: its "merge.table" child), summed, per answered query, in
ms."""
from bench.spans import per_answer_ms


def read(t):
    return per_answer_ms(t, ("merge.fetch",), "merge")
