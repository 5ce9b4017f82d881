"""The port's four example scripts (``examples/*_torch.py``) against the
JAX package's (``examples/*.py``), on the CPU.

Every script runs in a subprocess of its own, one CPU thread each, four at
a time: the torch scripts with ``--device cpu`` and small LM arguments,
the two JAX MLego scripts unchanged, the same two again through
``repro.api.MLegoSession(seed=1)`` (the script's ``MLegoSession`` name
bound to that seed), and JAX's ``train_lm.py`` at the torch run's
arguments.  A torch script's ``main`` returns the facts it printed; the
JAX scripts' are read from their printed lines.

Held equal: what the store's ranges and the cost model decide (model ids,
trained tokens, merged parts, components, store size, retrained gaps,
repartition spans, Alg. 4's totals).  The one exception is a
``submit_many`` batch where the reference's Alg. 4 loses to the per-query
plans: the port keeps the current plan as a candidate, so its total may
only be lower.  Held within a tolerance: each held-out lpp, which rests on
random draws that torch cannot reproduce, lies within 3x the spread of
JAX's lpp for the same query over session seeds 0 and 1, beyond the
interval the two seeds span.  The LM scripts: shapes and finiteness, the
restart's step and cursor equal to JAX's script's, and the loss after the
restart equal to an uninterrupted run's at the same step.
"""
import ast
import importlib.util
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.common import DeviceUnavailableError  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
SCRIPTS = ("quickstart", "interactive_analysis", "serve_lm", "train_lm")
LPP_SPREADS = 3.0
SERVE_ARGS = ["--batch", "2", "--prompt-len", "16", "--gen-len", "8"]
TRAIN_ARGS = ["--batch", "2", "--seq", "16"]
TIMEOUT_S = 600

# run a script's main(argv) and print what it returns as the last line
TORCH_MAIN = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("example", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print(json.dumps(mod.main(sys.argv[2:])))
"""
# run a JAX MLego script with its session's seed set
JAX_SEEDED = """
import functools, importlib.util, sys
import repro.api
spec = importlib.util.spec_from_file_location("example", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod.MLegoSession = functools.partial(repro.api.MLegoSession,
                                     seed=int(sys.argv[2]))
mod.main()
"""


def _env():
    env = dict(os.environ)
    env.update(PYTHONPATH=str(ROOT / "src") + os.pathsep
               + env.get("PYTHONPATH", ""),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    return env


def _script(name, torch_side=True):
    return str(EXAMPLES / (f"{name}_torch.py" if torch_side
                           else f"{name}.py"))


RUNS = {
    "quickstart": [TORCH_MAIN, _script("quickstart"), "--device", "cpu"],
    "interactive": [TORCH_MAIN, _script("interactive_analysis"),
                    "--device", "cpu"],
    "serve xlstm-1.3b": [TORCH_MAIN, _script("serve_lm"), "--device", "cpu",
                         "--arch", "xlstm-1.3b"] + SERVE_ARGS,
    "serve qwen3-1.7b": [TORCH_MAIN, _script("serve_lm"), "--device", "cpu",
                         "--arch", "qwen3-1.7b"] + SERVE_ARGS,
    "train 10": [TORCH_MAIN, _script("train_lm"), "--device", "cpu",
                 "--steps", "10"] + TRAIN_ARGS,
    "train 20": [TORCH_MAIN, _script("train_lm"), "--device", "cpu",
                 "--steps", "20"] + TRAIN_ARGS,
    "jax quickstart": [None, _script("quickstart", False)],
    "jax interactive": [None, _script("interactive_analysis", False)],
    "jax quickstart seed 1": [JAX_SEEDED, _script("quickstart", False), "1"],
    "jax interactive seed 1": [JAX_SEEDED,
                               _script("interactive_analysis", False), "1"],
    "jax train 10": [None, _script("train_lm", False), "--steps", "10"]
    + TRAIN_ARGS,
}


def _run(code, *args):
    cmd = [sys.executable] + (["-c", code] if code else []) + list(args)
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         env=_env(), timeout=TIMEOUT_S)
    if out.returncode != 0:
        raise AssertionError(f"{' '.join(args)} exited {out.returncode}:\n"
                             f"{out.stderr[-4000:]}")
    return out.stdout


@pytest.fixture(scope="module")
def runs():
    """Each run's standard output; a torch run's as its ``main`` dict."""
    with ThreadPoolExecutor(max_workers=4) as pool:
        futures = {k: pool.submit(_run, *v) for k, v in RUNS.items()}
        out = {k: f.result() for k, f in futures.items()}
    for k, v in RUNS.items():
        if v[0] == TORCH_MAIN:
            out[k] = json.loads(out[k].strip().splitlines()[-1])
    return out


def _quickstart_facts(text):
    """The facts of ``examples/quickstart.py``'s printed lines."""
    windows = re.findall(r"Interval\(lo=([\d.]+), hi=([\d.]+)\) \((\d+) docs",
                         text)
    union = re.search(r"plan: models (\(.*?\)), trained (\d+) tokens", text)
    narrow = re.search(r"plan: (\(.*?\)) \+ (\d+) fresh tokens -> lpp "
                       r"(-?[\d.]+)", text)
    store = re.search(r"store now holds (\d+) models \(([\d.]+) MB\)", text)
    pred = re.search(r"components: (\d+), merged (\d+) parts, lpp "
                     r"(-?[\d.]+)", text)
    return {
        "windows": [[float(lo), float(hi), int(n)] for lo, hi, n in windows],
        "union": {"models": list(ast.literal_eval(union.group(1))),
                  "trained_tokens": int(union.group(2))},
        "narrow": {"models": list(ast.literal_eval(narrow.group(1))),
                   "trained_tokens": int(narrow.group(2))},
        "store": {"models": int(store.group(1)), "mb": store.group(2)},
        "predicate": {"components": int(pred.group(1)),
                      "merged": int(pred.group(2))},
        "lpp": [float(re.search(r"held-out lpp: (-?[\d.]+)", text).group(1)),
                float(narrow.group(3)), float(pred.group(3))],
    }


def _interactive_facts(text):
    """The facts of ``examples/interactive_analysis.py``'s printed lines."""
    queries = re.findall(r"plan=(\d+) models \+\s*(\d+) tok  lpp=(-?[\d.]+)",
                         text)
    pred = re.search(r"components=(\d+) merged=(\d+) parts \+(\d+) tok  "
                     r"lpp=(-?[\d.]+)", text)
    batch = re.search(r"(\d+) queries in [\d.]+ms; benefit=([\d.]+) .*"
                      r"naive=([\d.]+) shared=([\d.]+)", text)
    workers = re.findall(r"worker (\d+): span\s+(\d+)\.\.\s+(\d+) \((\d+) "
                         r"docs merged", text)
    return {
        "queries": [[int(n), int(t)] for n, t, _ in queries],
        "store_models": int(re.search(r"store: (\d+) models", text).group(1)),
        "predicate": [int(x) for x in pred.groups()[:3]],
        "batch": [int(batch.group(1))] + list(batch.groups()[1:]),
        "retrained": int(re.search(r"retrained (\d+) gap models",
                                   text).group(1)),
        "workers": [[int(x) for x in w] for w in workers],
        "lpp": [float(q[2]) for q in queries] + [float(pred.group(4))],
    }


def _within_seed_spread(got, seed0, seed1):
    """Each port lpp within LPP_SPREADS x |seed0 - seed1| of the interval
    JAX's two seeds span."""
    assert len(got) == len(seed0) == len(seed1)
    for g, a, b in zip(got, seed0, seed1):
        spread = abs(a - b)
        assert min(a, b) - LPP_SPREADS * spread <= g \
            <= max(a, b) + LPP_SPREADS * spread, (got, seed0, seed1)


def test_quickstart_plans_match_jax(runs):
    t, j = runs["quickstart"], _quickstart_facts(runs["jax quickstart"])
    assert t["windows"] == j["windows"]
    for q in ("union", "narrow"):
        assert {k: t[q][k] for k in ("models", "trained_tokens")} == j[q]
    assert t["union"]["trained_tokens"] == 0
    assert [t["store"]["models"], f"{t['store']['bytes'] / 1e6:.1f}"] == \
        [j["store"]["models"], j["store"]["mb"]]
    assert {k: t["predicate"][k] for k in ("components", "merged")} == \
        j["predicate"]


def test_quickstart_lpp_within_jax_seed_spread(runs):
    t = runs["quickstart"]
    _within_seed_spread(
        [t[q]["lpp"] for q in ("union", "narrow", "predicate")],
        _quickstart_facts(runs["jax quickstart"])["lpp"],
        _quickstart_facts(runs["jax quickstart seed 1"])["lpp"])


def test_interactive_plans_match_jax(runs):
    t, j = runs["interactive"], _interactive_facts(runs["jax interactive"])
    assert [[q["reused"], q["trained_tokens"]] for q in t["queries"]] == \
        j["queries"]
    assert t["store_models"] == j["store_models"]
    p = t["predicate"]
    assert [p["components"], p["merged"], p["trained_tokens"]] == \
        j["predicate"]
    assert len(t["retrained"]) == j["retrained"]
    assert [[w, round(lo), round(hi), n] for w, lo, hi, n in t["workers"]] \
        == j["workers"]


def test_interactive_batch_matches_jax_or_beats_its_alg4(runs):
    b = runs["interactive"]["batch"]
    j = _interactive_facts(runs["jax interactive"])["batch"]
    assert b["queries"] == j[0] == 3
    got = [f"{b[k]:.4f}" for k in ("benefit", "naive", "shared")]
    if got != j[1:]:
        # the reference's Alg. 4 lost to the per-query plans here
        assert b["shared"] < float(j[3]), (got, j)


def test_interactive_lpp_within_jax_seed_spread(runs):
    t = runs["interactive"]
    _within_seed_spread(
        [q["lpp"] for q in t["queries"]] + [t["predicate"]["lpp"]],
        _interactive_facts(runs["jax interactive"])["lpp"],
        _interactive_facts(runs["jax interactive seed 1"])["lpp"])


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "qwen3-1.7b"])
def test_serve_generates_finite_greedy_tokens(runs, arch):
    r = runs[f"serve {arch}"]
    assert r["arch"] == f"{arch}-reduced" and r["device"] == "cpu"
    assert r["tokens_shape"] == [2, 8]
    assert r["logits_finite"] is True
    toks = np.asarray(r["tokens"])
    assert toks.shape == (2, 8)
    assert ((toks >= 0) & (toks < r["padded_vocab"])).all()


def test_train_resumes_at_jax_scripts_step_and_cursor(runs):
    r = runs["train 10"]
    text = runs["jax train 10"]
    m = re.search(r"resumed at step (\d+) \(cursor (\d+)\)", text)
    assert [r["resumed_step"], r["resumed_cursor"]] == \
        [int(m.group(1)), int(m.group(2))] == [10, 10]
    assert r["final_step"] == 20 and r["tokens_shape"] == [2, 16]
    assert [s for s, _ in r["losses"]] == \
        [int(s) for s in re.findall(r"step\s+(\d+) loss", text)]
    assert r["params"] == int(re.search(r"([\d,]+) params",
                                        text).group(1).replace(",", ""))
    assert all(np.isfinite(loss) for _, loss in r["losses"])


def test_train_restart_continues_from_the_checkpoint(runs):
    """Restarted at step 10, the loss at step 20 is an uninterrupted run's
    at step 20 (the same batches, weights and optimizer state)."""
    resumed = dict(runs["train 10"]["losses"])
    straight = dict(runs["train 20"]["losses"])
    assert runs["train 20"]["resumed_step"] == 20
    assert resumed[10] == straight[10] and resumed[20] == straight[20]


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_imports_neither_jax_nor_repro(name):
    tree = ast.parse(Path(_script(name)).read_text())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    assert mods and all(m.split(".")[0] not in ("jax", "jaxlib", "repro")
                        for m in mods), mods
    assert any(m.startswith("repro_torch") for m in mods)


@pytest.mark.parametrize("name", SCRIPTS)
def test_cuda_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = importlib.util.spec_from_file_location(f"{name}_torch",
                                                  _script(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(DeviceUnavailableError):
        mod.main(["--device", "cuda"])
    with pytest.raises(DeviceUnavailableError):
        mod.main([])
