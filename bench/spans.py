"""What the readers of the program's child spans share: the time of
the spans of some names that lie under a parent span of the window
("train", "merge"), found by their parent ids."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def _under(t, names: Sequence[str], parent: str) -> Tuple[List[float], int]:
    """(durations of the spans named ``names`` whose parent chain reaches
    a ``parent`` span of the window, count of those parent spans)."""
    if t is None:
        return [], 0
    by_id = {s.span_id: s for s in t.spans}
    parents = {s.span_id for s in t.spans if s.name == parent}
    out = []
    for s in t.spans:
        if s.name not in names:
            continue
        p = s.parent_id
        while p is not None and p not in parents and p in by_id:
            p = by_id[p].parent_id
        if p in parents:
            out.append(s.duration_s)
    return out, len(parents)


def per_parent_ms(t, names: Sequence[str], parent: str) -> Optional[float]:
    """The spans' time per ``parent`` span, in ms; None without them."""
    secs, n = _under(t, names, parent)
    return sum(secs) / n * 1e3 if secs else None


def per_answer_ms(t, names: Sequence[str], parent: str) -> Optional[float]:
    """The spans' time per answered query, in ms; None without them."""
    secs, _ = _under(t, names, parent)
    if not secs or t.answered <= 0:
        return None
    return sum(secs) / t.answered * 1e3
