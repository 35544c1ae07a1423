"""kimi-k2-1t-a32b — Kimi K2, trillion-param MoE (paper-table numbers).

[arXiv:2501.kimi2; unverified] 61L d_model=7168 64H (GQA kv=8)
d_ff(expert)=2048 vocab=163840, MoE 384 routed top-8 + 1 shared; first layer
dense (d_ff=18432 per the public config.json).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=18432,  # dense first layer
    vocab_size=163840,
    head_dim=128,
    moe=True,
    n_experts=384,
    n_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    first_dense_layers=1,
    source="arXiv:2501.kimi2; unverified",
)
