"""The explore cells at sizes a CPU test can hold: the benchmark's tiny
tree (``tiny.py``) with both explore configurations cut to tens of
leaves and the loop to a few analysts."""
from __future__ import annotations

import json
from pathlib import Path

from bench.tests.tiny import tiny_tree

CELLS = ("nytimes-vb-explore", "pubmed-vb-explore")
TINY_CONFIG = {
    "nytimes-vb": ({}, {}, 25),
    "pubmed-vb": ({"n_docs": 500, "vocab_size": 250, "n_topics": 6,
                   "mean_doc_len": 20, "attr_max": 500},
                  {"n_topics": 6, "vocab_size": 250}, 25),
}
TINY_TRAFFIC = {"analysts": 6, "widths_leaves": [1, 2, 4, 8],
                "warmup_queries": 6, "check_answers": 3, "check_from": 12}


def explore_tree(dst: Path) -> Path:
    """``tiny_tree`` with the explore configurations and cells cut."""
    tiny_tree(dst)
    for name, (corpus, lda, leaf) in TINY_CONFIG.items():
        p = dst / "bench" / "configs" / f"{name}.json"
        c = json.loads(p.read_text())
        c["corpus"].update(corpus)
        c["lda"].update(lda)
        c["capital"]["leaf_units"] = leaf
        c["backend"]["capacity"] = 64
        p.write_text(json.dumps(c))
    for cell in CELLS:
        p = dst / "bench" / "workloads" / f"{cell}.json"
        w = json.loads(p.read_text())
        w.update(TINY_TRAFFIC)
        p.write_text(json.dumps(w))
    return dst
