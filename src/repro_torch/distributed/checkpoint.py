"""Fault-tolerant checkpointing.

The port of ``src/repro/distributed/checkpoint.py``, in the same on-disk
format, so each package reads the other's checkpoints.  Atomic
(write-to-tmp + rename), content-hashed, keep-N pruned tree checkpoints.
A checkpoint is a directory:

    step_000123/
      manifest.json   {step, meta, leaves: [{path, file, sha, dtype, shape}]}
      leaf_*.npy      one blob per tree leaf

A tree is nested dicts, lists and tuples of tensors or numpy arrays;
each leaf is written through numpy, in JAX's leaf order (dict keys
sorted) with "a/b/0/c" paths.  NumPy has no bfloat16, so a bfloat16
leaf raises: the trainer's masters and optimizer state are float32.
Restores are verified against the manifest hashes (a torn write or bit
rot is an ``IOError``, not a silently corrupt resume), and the tree is
rebuilt from the paths: integer components become list indices,
everything else dict keys.  Leaves come back as CPU tensors.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    return [x for k, v in items
            for x in _flatten_with_paths(v, f"{prefix}/{k}" if prefix else k)]


def _unflatten_from_paths(paths: List[str], leaves: List[Any]) -> Any:
    """Rebuild nested dicts/lists from 'a/b/0/c' style paths."""
    root: Dict = {}
    for path, leaf in zip(paths, leaves):
        parts = path.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(re.fullmatch(r"\d+", k) for k in keys):
            return [fix(node[str(i)]) for i in range(len(keys))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("a bfloat16 leaf cannot be checkpointed: numpy "
                            "has no bfloat16 (keep float32 masters)")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _sha(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def _step_dirs(self) -> List[Tuple[int, str]]:
        out = []
        for name in os.listdir(self.root):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.root, name,
                                                 "manifest.json")):
                out.append((int(m.group(1)), os.path.join(self.root, name)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        dirs = self._step_dirs()
        return dirs[-1][0] if dirs else None

    def save(self, tree: Any, meta: Optional[Dict] = None, step: int = 0
             ) -> str:
        final = os.path.join(self.root, f"step_{step:09d}")
        tmp = tempfile.mkdtemp(dir=self.root, prefix=".tmp_")
        manifest = {"step": step, "meta": meta or {}, "leaves": []}
        try:
            for i, (path, leaf) in enumerate(_flatten_with_paths(tree)):
                arr = _to_numpy(leaf)
                fname = f"leaf_{i:05d}.npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"].append({
                    "path": path, "file": fname,
                    "sha": _sha(os.path.join(tmp, fname)),
                    "dtype": str(arr.dtype), "shape": list(arr.shape),
                })
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)   # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._prune()
        return final

    def _prune(self) -> None:
        dirs = self._step_dirs()
        for _, d in dirs[: max(0, len(dirs) - self.keep)]:
            shutil.rmtree(d, ignore_errors=True)

    def restore(self, step: int, verify: bool = True) -> Tuple[Any, Dict]:
        """(tree of CPU tensors, meta with "step")."""
        d = os.path.join(self.root, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        paths, leaves = [], []
        for e in manifest["leaves"]:
            blob = os.path.join(d, e["file"])
            if verify and _sha(blob) != e["sha"]:
                raise IOError(f"checksum mismatch: {blob}")
            paths.append(e["path"])
            leaves.append(torch.from_numpy(np.load(blob)))
        tree = _unflatten_from_paths(paths, leaves)
        meta = dict(manifest["meta"])
        meta.setdefault("step", manifest["step"])
        return tree, meta

    def restore_latest(self, verify: bool = True
                       ) -> Optional[Tuple[Any, Dict]]:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, verify=verify)
