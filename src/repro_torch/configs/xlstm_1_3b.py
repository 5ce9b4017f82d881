"""xlstm-1.3b — sLSTM + mLSTM blocks.  [arXiv:2405.04517; unverified]

48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304.  d_ff=0: the xLSTM
blocks carry their own up/down projections, there is no separate FFN.
Pattern: 7 mLSTM : 1 sLSTM (period 8) — 42 mLSTM + 6 sLSTM layers.
Sub-quadratic (constant-size recurrent state) => long_500k runs.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("m", "m", "m", "m", "m", "m", "m", "s"),
    tie_embeddings=True,
    sub_quadratic=True,
)
