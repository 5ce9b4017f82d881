"""Pluggable trainer registry — one place that knows how to fit Θ.

The paper's materialized-model tuple ⟨o, N, Θ⟩ is agnostic to the
inference algorithm that produced Θ; only the *merge* (Alg. 1 vs
Alg. 2) and the trainer differ per kind.  A new model kind plugs in
without touching the planner or the session:

    register_trainer("my_kind", my_fit_fn)

A trainer maps a sub-corpus to the mergeable parameter dict:

    fn(corpus: Corpus, cfg: LDAConfig, gen: torch.Generator) -> Dict[str, np.ndarray]

and runs on ``gen.device`` — the session hands every training call a
child generator on the session's device.

Each kind also carries its *merge family* — how a homogeneous list of
its models combines into a topic matrix β.  Pass ``merge=`` a callable
``(models, cfg) -> β`` or the name of a built-in family (``"vb"``:
Alg. 1 natural-parameter addition over ``theta["lam"]``; ``"gs"``:
Alg. 2 count addition over ``theta["delta_nkv"]``).

Built-in: ``"vb"`` (variational Bayes, Alg. 1 family).  The collapsed
Gibbs kind (``"gs"``, alias ``"gibbs"``) is not ported yet, so it
resolves as an unknown kind.  Kinds are canonicalized through
:func:`resolve_kind` so the store tags models consistently regardless
of which alias the caller used.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.lda_default import LDAConfig
from repro_torch.core.lda import (
    MaterializedModel,
    topics_from_gs,
    topics_from_vb,
)
from repro_torch.core.merge import merge_gs, merge_vb
from repro_torch.core.vb import vb_fit
from repro_torch.data.corpus import Corpus, doc_term_matrix

TrainerFn = Callable[[Corpus, LDAConfig, torch.Generator],
                     Dict[str, np.ndarray]]
MergeFn = Callable[[Sequence[MaterializedModel], LDAConfig], np.ndarray]


def _merge_vb_family(models: Sequence[MaterializedModel],
                     cfg: LDAConfig) -> np.ndarray:
    return topics_from_vb(merge_vb(models, cfg))


def _merge_gs_family(models: Sequence[MaterializedModel],
                     cfg: LDAConfig) -> np.ndarray:
    return topics_from_gs(merge_gs(models, cfg), cfg.eta)


_MERGE_FAMILIES: Dict[str, MergeFn] = {
    "vb": _merge_vb_family,
    "gs": _merge_gs_family,
}

_TRAINERS: Dict[str, TrainerFn] = {}
_MERGES: Dict[str, MergeFn] = {}
_ALIASES: Dict[str, str] = {}


def register_trainer(kind: str, fn: TrainerFn,
                     *, merge: Union[str, MergeFn] = "vb",
                     aliases: Tuple[str, ...] = ()) -> None:
    """Register (or replace) the trainer (and merge family) for a kind."""
    if not kind or not isinstance(kind, str):
        raise ValueError(f"trainer kind must be a non-empty string, got {kind!r}")
    if isinstance(merge, str):
        if merge not in _MERGE_FAMILIES:
            raise ValueError(f"unknown merge family {merge!r}; one of "
                             f"{sorted(_MERGE_FAMILIES)} or a callable")
        merge = _MERGE_FAMILIES[merge]
    for a in aliases:
        if a in _TRAINERS and a != kind:
            raise ValueError(f"alias {a!r} would shadow the registered "
                             f"kind {a!r}")
    _TRAINERS[kind] = fn
    _MERGES[kind] = merge
    _ALIASES.pop(kind, None)     # explicit registration wins over an alias
    for a in aliases:
        _ALIASES[a] = kind


def resolve_kind(kind: str) -> str:
    """Canonical kind name (follows aliases); raises on unknown kinds."""
    kind = _ALIASES.get(kind, kind)
    if kind not in _TRAINERS:
        raise ValueError(
            f"unknown model kind {kind!r}; registered: "
            f"{sorted(_TRAINERS)} (aliases: {sorted(_ALIASES)}). "
            "Use repro_torch.api.register_trainer to add one.")
    return kind


def get_trainer(kind: str) -> TrainerFn:
    return _TRAINERS[resolve_kind(kind)]


def get_merge(kind: str) -> MergeFn:
    return _MERGES[resolve_kind(kind)]


def merge_family_name(kind: str) -> Optional[str]:
    """Built-in merge family this kind uses ("vb" / "gs"), or None.

    Kinds registered with a custom merge *callable* return None — they
    have no known device form and must merge on the host."""
    fn = _MERGES[resolve_kind(kind)]
    for name, fam in _MERGE_FAMILIES.items():
        if fn is fam:
            return name
    return None


def available_trainers() -> Tuple[str, ...]:
    return tuple(sorted(_TRAINERS))


# --- built-ins -------------------------------------------------------------

def _train_vb(corpus: Corpus, cfg: LDAConfig,
              gen: torch.Generator) -> Dict[str, np.ndarray]:
    # the E-step wrapper: the kernel on a CUDA generator, its plain
    # version on a CPU one — every backend trains on the card the same way
    x = doc_term_matrix(corpus)
    return {"lam": vb_fit(x, gen, cfg, use_kernel=True).cpu().numpy()}


register_trainer("vb", _train_vb, merge="vb")
