"""qwen3-1.7b — dense, qk_norm, GQA.  [hf:Qwen/Qwen3-1.7B config.json]

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    sub_quadratic=False,
)
