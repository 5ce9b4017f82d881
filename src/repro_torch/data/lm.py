"""LM data pipeline: deterministic, cursor-addressable synthetic batches.

The port of ``src/repro/data/lm.py`` for the token models the port
serves.  A batch is a pure function of (seed, cursor), drawn from a CPU
``torch.Generator`` seeded from both, so the same call gives the same
tokens on any device (the numbers differ from the JAX package's, whose
stream is ``jax.random``).  The VLM patch and audio frame stubs come with
their model families (ROADMAP.md Queue 1 item 2b).
"""
from __future__ import annotations

from typing import Dict, Union

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
    ``labels``, the tokens shifted left with a 0 at the end; drawn on the
    CPU, then moved to ``device`` (default: left on the CPU)."""
    gen = _generator(seed, cursor)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           dtype=torch.int32)
    labels = torch.cat([tokens[:, 1:],
                        torch.zeros((batch, 1), dtype=torch.int32)], dim=1)
    out = {"tokens": tokens, "labels": labels}
    if device is not None:
        out = {k: v.to(device) for k, v in out.items()}
    return out

