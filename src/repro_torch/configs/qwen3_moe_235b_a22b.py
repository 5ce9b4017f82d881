"""qwen3-moe-235b-a22b — 128 experts top-8 MoE.

[hf:Qwen/Qwen3-30B-A3B; hf]
94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936, MoE 128e top-8.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    n_experts=128,
    moe_top_k=8,
    d_ff_expert=1536,
    rope_theta=1000000.0,
    act="silu",
    sub_quadratic=False,
)
