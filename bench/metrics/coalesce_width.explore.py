"""coalesce_width.explore: queries per execution group the service
drained in the window (its counters: width_sum over groups), the width
of the batches the pointer-table merge reads."""


def read(t):
    groups = t.counters.get("groups", 0) if t is not None else 0
    if groups <= 0:
        return None
    return t.counters["width_sum"] / groups
