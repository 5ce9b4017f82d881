"""whisper-tiny — enc-dec, conv frontend (STUB).  [arXiv:2212.04356; unverified]

4L d_model=384 6H (GQA kv=6) d_ff=1536 vocab=51865.  LayerNorm + GELU.
The conv frontend is a STUB: ``input_specs()`` provides precomputed
mel-frame embeddings (1500 frames) for the encoder.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    act="gelu",
    norm="layernorm",
    is_encoder_decoder=True,
    n_encoder_layers=4,
    encoder_seq=1500,
    norm_eps=1e-5,
    sub_quadratic=False,
)
