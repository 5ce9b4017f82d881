"""llava-next-34b — VLM backbone, anyres tiling (frontend stub).

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.

The vision tower is a STUB: ``input_specs()`` provides precomputed
patch embeddings (anyres default: 2880 patch positions = 5 tiles x 576)
that are spliced in front of the token embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    n_patches=2880,
    rope_theta=1000000.0,
    sub_quadratic=False,
)
