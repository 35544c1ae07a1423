"""zamba2-2.7b — Zamba2 hybrid: Mamba2 backbone + ONE shared attention
block invoked every 6 SSM blocks (weight reuse is the Zamba trick).

[arXiv:2411.15242; hf] 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64. At 500k decode the shared attention runs a 4096 sliding
window (documented deviation; full attention would be O(L^2)).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm=True,
    ssm_state=64,
    ssm_expand=2,
    ssm_heads=40,  # d_inner=5120, headdim=128
    attn_every=6,
    sliding_window=4096,
    subquadratic=True,
    source="arXiv:2411.15242; hf",
)
