"""qwen2.5-14b — GQA, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    sub_quadratic=False,
)
