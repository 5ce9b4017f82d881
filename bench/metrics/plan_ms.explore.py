"""plan_ms.explore: the program's "plan" spans (single and batch
search), summed over the window, per answered query, in ms."""


def read(t):
    if t is None or t.answered <= 0:
        return None
    spans = [s for s in t.spans if s.name == "plan"]
    if not spans:
        return None
    return sum(s.duration_s for s in spans) / t.answered * 1e3
