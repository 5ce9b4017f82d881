"""LM data pipeline: deterministic, cursor-addressable synthetic batches.

The port of ``src/repro/data/lm.py``: ``make_batch`` and
``batch_stream``, the cursor-ordered batches the trainer reads.  A batch is a
pure function of (seed, cursor), drawn from a CPU ``torch.Generator``
seeded from both, so the same call gives the same tokens on any device
(the numbers differ from the JAX package's, whose stream is
``jax.random``).  The modality frontends are stubs, as in JAX: the VLM
gets precomputed patch embeddings, the encoder–decoder precomputed mel
frame embeddings, both drawn from the same generator.
"""
from __future__ import annotations

from typing import Dict, Iterator, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def encoder_frames(cfg: ArchConfig) -> int:
    """Stub mel-frontend frame count, padded as in the JAX package."""
    return _round_up(cfg.encoder_seq, 256)


def _generator(seed: int, cursor: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, cursor]).generate_state(2)
    return torch.Generator().manual_seed(
        int(state[0]) << 32 | int(state[1]))


def make_batch(cfg: ArchConfig, batch: int, seq: int, seed: int,
               cursor: int, device: Union[str, torch.device, None] = None
               ) -> Dict[str, torch.Tensor]:
    """One batch for (arch, B, S) at stream position ``cursor``: int32
    ``tokens`` (B, S) uniform over the (unpadded) vocabulary and
    ``labels``, the tokens shifted left with a 0 at the end; for the VLM
    ``patch_embeds`` (B, min(n_patches, S), d) N(0, 0.02²), whose
    positions carry no target (label -1); for the encoder–decoder
    ``frames`` (B, encoder_frames, d) N(0, 0.02²).  Drawn on the CPU, then
    moved to ``device`` (default: left on the CPU)."""
    gen = _generator(seed, cursor)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           dtype=torch.int32)
    labels = torch.cat([tokens[:, 1:],
                        torch.zeros((batch, 1), dtype=torch.int32)], dim=1)
    out = {"tokens": tokens, "labels": labels}
    if cfg.family == "vlm" and cfg.n_patches:
        p = min(cfg.n_patches, seq)
        out["patch_embeds"] = torch.randn(
            (batch, p, cfg.d_model), generator=gen).mul_(0.02)
        labels[:, :p] = -1
    if cfg.is_encoder_decoder:
        out["frames"] = torch.randn(
            (batch, encoder_frames(cfg), cfg.d_model),
            generator=gen).mul_(0.02)
    if device is not None:
        out = {k: v.to(device) for k, v in out.items()}
    return out



def batch_stream(cfg: ArchConfig, batch: int, seq: int, *, seed: int = 0,
                 start_cursor: int = 0,
                 device: Union[str, torch.device, None] = None
                 ) -> Iterator[Dict[str, torch.Tensor]]:
    """``make_batch`` at cursors ``start_cursor``, ``start_cursor + 1``,
    ..., each batch moved to ``device``."""
    cursor = start_cursor
    while True:
        yield make_batch(cfg, batch, seq, seed, cursor, device)
        cursor += 1
