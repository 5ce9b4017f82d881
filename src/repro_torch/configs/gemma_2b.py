"""gemma-2b — GeGLU, head_dim=256, MQA.  [arXiv:2403.08295; hf]

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=256000.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=256000,
    head_dim=256,
    act="gelu",
    tie_embeddings=True,
    scale_embeds=True,
    sub_quadratic=False,
)
