"""merge_finish_ms.explore: the program's "merge.finish" spans under its
"merge" spans alone (the family's finish of each answer in numpy on the
host), summed, per answered query, in ms."""
from bench.spans import per_answer_ms


def read(t):
    return per_answer_ms(t, ("merge.finish",), "merge")
