"""recurrentgemma-9b — RG-LRU + local attention, 1:2.  [arXiv:2402.19427; unverified]

38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000.
Pattern: (rec, rec, local) repeated; 38 layers => 12 triples + (rec, rec).
Sub-quadratic (RG-LRU state + 2048 local window) => long_500k runs.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    act="gelu",
    block_pattern=("rec", "rec", "local"),
    window=2048,
    tie_embeddings=True,
    scale_embeds=True,
    sub_quadratic=True,
)
