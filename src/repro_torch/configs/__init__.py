"""Configurations of the port: the LDA model MLego trains and merges, and
the architecture registry of the LM scaffolding (``--arch <id>``)."""
from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES_BY_NAME,
    TRAIN_4K,
    ArchConfig,
    ShapeConfig,
)
from repro_torch.configs.lda_default import DEFAULT as LDA_DEFAULT
from repro_torch.configs.lda_default import LDAConfig

from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _llama4
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as _qwen3moe
from repro_torch.configs.xlstm_1_3b import CONFIG as _xlstm
from repro_torch.configs.qwen3_1_7b import CONFIG as _qwen3
from repro_torch.configs.smollm_360m import CONFIG as _smollm
from repro_torch.configs.gemma_2b import CONFIG as _gemma
from repro_torch.configs.qwen2_5_14b import CONFIG as _qwen25
from repro_torch.configs.llava_next_34b import CONFIG as _llava
from repro_torch.configs.whisper_tiny import CONFIG as _whisper
from repro_torch.configs.recurrentgemma_9b import CONFIG as _rgemma

ARCHS = {
    c.name: c
    for c in (
        _llama4,
        _qwen3moe,
        _xlstm,
        _qwen3,
        _smollm,
        _gemma,
        _qwen25,
        _llava,
        _whisper,
        _rgemma,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES_BY_NAME:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES_BY_NAME)}")
    return SHAPES_BY_NAME[name]


__all__ = [
    "ARCHS",
    "ALL_SHAPES",
    "ArchConfig",
    "ShapeConfig",
    "LDAConfig",
    "LDA_DEFAULT",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "get_arch",
    "get_shape",
]
