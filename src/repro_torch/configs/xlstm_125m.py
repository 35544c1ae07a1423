"""xlstm-125m — xLSTM (mLSTM + sLSTM blocks, 7:1 ratio).

[arXiv:2405.04517; unverified] 12L d_model=768 4H (kv=4) d_ff=0 vocab=50304.
Blocks are mLSTM (matrix memory, parallel train form) with an sLSTM every
4th layer (lax.scan recurrence). Constant-state decode -> runs long_500k.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=192,
    xlstm=True,
    ssm_expand=2,
    slstm_every=4,
    subquadratic=True,
    source="arXiv:2405.04517; unverified",
)
