"""merge_parts.explore: the models the window's merges read (the
backend's "merge_parts" counter over the window), per answered query."""


def read(t):
    if t is None or t.answered <= 0 or "merge_parts" not in t.counters:
        return None
    return t.counters["merge_parts"] / t.answered
