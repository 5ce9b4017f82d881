"""gap_train_ms: the program's "train" spans, per trained gap, in ms."""


def read(t):
    spans = [s for s in t.spans if s.name == "train"] if t is not None else []
    if not spans:
        return None
    return sum(s.duration_s for s in spans) / len(spans) * 1e3
