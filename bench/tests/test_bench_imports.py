"""Nothing the benchmark runs loads JAX, the JAX package or the old
benchmarks; the reference loads nothing of the program either.

Names are compared by their top-level part, whole: ``repro_torch``
begins with ``repro`` and is the program, not the JAX package.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_of_the_benchmark_imports_a_forbidden_package():
    for path in BENCH.rglob("*.py"):
        assert not _imported_tops(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in _imported_tops(path), path


def test_a_run_s_whole_module_graph_loads_no_forbidden_module():
    """Import run.py, every module under bench/ and every program module
    the entries import when they run, in a fresh process."""
    code = r"""
import importlib, importlib.util, pathlib, sys
sys.path.insert(0, "bench")
import run
root = pathlib.Path("bench")
for p in sorted(root.rglob("*.py")):
    if "tests" in p.parts or p.name == "run.py":
        continue
    if p.parent.name == "metrics":
        run.load_reader(p.stem)
    else:
        importlib.import_module(".".join(p.with_suffix("").parts))
for name in ("repro_torch.api.backend", "repro_torch.api.session",
             "repro_torch.api.spec", "repro_torch.core.plans",
             "repro_torch.core.store", "repro_torch.obs.trace",
             "repro_torch.serve.service", "repro_torch.data.corpus",
             "repro_torch.configs.lda_default", "repro_torch.core.vb",
             "repro_torch.core.gibbs"):
    importlib.import_module(name)
print(" ".join(run.forbidden_modules()))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "", r.stdout


def test_the_run_s_own_guard_names_a_forbidden_module():
    code = ("import sys, types; sys.path.insert(0, 'bench'); import run; "
            "sys.modules['jaxlib.xla'] = types.ModuleType('jaxlib.xla'); "
            "print(run.forbidden_modules())")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.stdout.strip() == "['jaxlib']", r.stderr
