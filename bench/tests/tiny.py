"""A copy of the benchmark's tree at sizes a CPU test can hold, and a
way to run one of its cells on the CPU in a fresh process.

The copy holds ``BENCHMARK.json`` and ``bench/`` only; the program
comes from ``src/`` of this checkout through ``PYTHONPATH``.  Its two
cells keep their names, entries, limits and traffic shapes, at tiny
corpora (hundreds of documents, V of a few hundred, K of 6 to 8).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional, Tuple

ROOT = Path(__file__).resolve().parents[2]

TINY = {
    "nytimes-vb": ({"n_docs": 400, "vocab_size": 300, "n_topics": 8,
                    "mean_doc_len": 30, "attr_max": 400},
                   {"n_topics": 8, "vocab_size": 300, "max_iters": 15,
                    "e_step_iters": 8}, 100),
    "enron-gs": ({"n_docs": 600, "vocab_size": 200, "n_topics": 6,
                  "mean_doc_len": 20, "attr_max": 600},
                 {"n_topics": 6, "vocab_size": 200, "gibbs_sweeps": 10}, 50),
}
TINY_TRAFFIC = {
    "nytimes-vb-capital": {"window_units": 100},
    "enron-gs-gapped": {"width_min": 120, "width_max": 300, "analysts": 3,
                        "rate_per_s": 4.0, "warmup_queries": 3,
                        "check_answers": 2},
}


def tiny_tree(dst: Path) -> Path:
    """Copy the benchmark to ``dst`` and shrink its two cells."""
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    shutil.copytree(ROOT / "bench", dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, (corpus, lda, leaf) in TINY.items():
        p = dst / "bench" / "configs" / f"{name}.json"
        c = json.loads(p.read_text())
        c["corpus"].update(corpus)
        c["lda"].update(lda)
        c["capital"]["leaf_units"] = leaf
        c["backend"]["capacity"] = 64
        p.write_text(json.dumps(c))
    for name, traffic in TINY_TRAFFIC.items():
        p = dst / "bench" / "workloads" / f"{name}.json"
        w = json.loads(p.read_text())
        w.update(traffic)
        p.write_text(json.dumps(w))
    return dst


def run_cpu(tree: Path, cell: str, *, seed: int = 2147483693,
            seconds: float = 1.0, trace: int = 0, patch: str = "",
            with_src: bool = True) -> Tuple[int, Optional[dict], str]:
    """Run ``cell`` of ``tree`` once on the CPU route in a fresh
    process, after running ``patch`` (Python source that may break the
    program underneath).  Returns (exit code, result line or None,
    standard error)."""
    code = "\n".join([
        "import sys",
        f"sys.path.insert(0, {str(tree / 'bench')!r})",
        "import run",
        patch,
        f"sys.exit(run.main(['--workload', {cell!r}, '--seed', '{seed}', "
        f"'--seconds', '{seconds}', '--trace', '{trace}'], device='cpu'))",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") if with_src else "",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=tree, env=env,
                       capture_output=True, text=True, timeout=300)
    lines = r.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if r.returncode == 0 and lines else None
    return r.returncode, result, r.stderr
