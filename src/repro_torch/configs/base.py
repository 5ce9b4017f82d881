"""Architecture + shape configuration system.

Every assigned architecture is a frozen ``ArchConfig``; reduced variants
(for CPU tests) come from ``ArchConfig.reduced()``.  A copy of the JAX
package's ``configs/base.py``: the widths, the reduced variants and the
padded vocabulary are the same, so both packages build the same shapes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclass(frozen=True)
class ArchConfig:
    """A transformer-family architecture from the assigned pool."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # --- optional knobs -------------------------------------------------
    head_dim: Optional[int] = None        # defaults to d_model // n_heads
    qk_norm: bool = False                 # qwen3-style per-head RMSNorm on q/k
    qkv_bias: bool = False                # qwen2.5-style bias on qkv projections
    act: str = "silu"                     # silu (SwiGLU) | gelu (GeGLU)
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0                    # 0 => dense FFN
    moe_top_k: int = 0
    d_ff_expert: int = 0                  # per-expert hidden dim
    n_shared_experts: int = 0             # always-on shared expert(s)
    capacity_factor: float = 1.25

    # Block pattern for non-pure-attention stacks.  Entries:
    #   "attn"  — global self attention + FFN
    #   "local" — sliding-window attention + FFN
    #   "rec"   — RG-LRU recurrent block + FFN
    #   "m"     — mLSTM block
    #   "s"     — sLSTM block
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0                       # sliding-window size for "local"

    # Encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 0                  # stub frontend frame count

    # VLM (llava): number of stub patch-embedding positions
    n_patches: int = 0

    # Whether the architecture is sub-quadratic and can run long_500k
    sub_quadratic: bool = False

    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    scale_embeds: bool = False            # gemma-style sqrt(d) embed scaling

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to a multiple of 256, as in the JAX package, so
        that logits and the greedy argmax run over the same columns."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def supports_shape(self, shape: ShapeConfig) -> bool:
        """Which assigned (arch x shape) cells are runnable (cf. DESIGN.md)."""
        if shape.name == "long_500k" and not self.sub_quadratic:
            return False
        return True

    # --- parameter accounting (used by the cost model & roofline) ------
    def param_count(self) -> int:
        d, v = self.d_model, self.vocab_size
        n = v * d  # embed
        if not self.tie_embeddings:
            n += v * d  # unembed
        for kind in self.layer_kinds():
            if kind in ("attn", "local"):
                n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                n += self._ffn_params()
            elif kind == "rec":
                # Griffin recurrent block: in/out proj + conv4 + gates
                d_rnn = d
                n += 2 * d * d_rnn + 4 * d_rnn + 2 * d_rnn * d_rnn + d_rnn * d
                n += self._ffn_params()
            elif kind == "m":
                # mLSTM: qkv + gates + out
                n += 4 * d * d + 2 * d * self.n_heads
            elif kind == "s":
                n += 4 * d * d + 4 * d * self.n_heads
            n += 2 * d  # norms
        if self.is_encoder_decoder:
            # encoder layers: attn + ffn; decoder cross-attn already in layers
            for _ in range(self.n_encoder_layers):
                n += 4 * d * d + self._ffn_params() + 2 * d
            # decoder cross attention
            n += self.n_layers * (4 * d * d)
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        expert_p = 3 * d * self.d_ff_expert
        all_expert = self.n_layers * self.n_experts * expert_p
        active_expert = self.n_layers * (self.moe_top_k + self.n_shared_experts) * expert_p
        return total - all_expert + active_expert

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.is_moe:
            return (
                self.n_experts * 3 * d * self.d_ff_expert
                + self.n_shared_experts * 3 * d * self.d_ff_expert
                + d * self.n_experts  # router
            )
        return 3 * d * self.d_ff  # gate/up/down

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expand block_pattern to exactly n_layers entries."""
        reps = (self.n_layers + len(self.block_pattern) - 1) // len(self.block_pattern)
        return (self.block_pattern * reps)[: self.n_layers]

    def model_flops(self, shape: ShapeConfig) -> float:
        """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for §Roofline."""
        n = self.active_param_count()
        if shape.kind == "train":
            return 6.0 * n * shape.tokens
        if shape.kind == "prefill":
            return 2.0 * n * shape.tokens
        # decode: one new token per sequence
        return 2.0 * n * shape.global_batch

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        pattern = self.block_pattern
        n_layers = max(2, min(len(pattern) + 1, 4))
        if self.family == "hybrid":
            n_layers = 4  # covers (rec, rec, attn) + tail rec
        if self.family == "ssm":
            n_layers = 3  # m, m, s with period shrunk below
            pattern = ("m", "m", "s")
        kv = min(self.n_kv_heads, 2)
        heads = max(2 * kv, 2)
        hd = 16
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            d_model=hd * heads,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=hd,
            d_ff=64,
            d_ff_expert=32 if self.is_moe else 0,
            n_experts=min(self.n_experts, 4),
            moe_top_k=min(self.moe_top_k, 2) if self.is_moe else 0,
            capacity_factor=4.0 if self.is_moe else self.capacity_factor,
            vocab_size=256,
            block_pattern=pattern,
            window=min(self.window, 16) if self.window else 0,
            n_encoder_layers=2 if self.is_encoder_decoder else 0,
            encoder_seq=8 if self.is_encoder_decoder else 0,
            n_patches=4 if self.n_patches else 0,
            dtype="float32",
        )
