"""qwen3-0.6b — Qwen3 0.6B (qk_norm, GQA).

[hf:Qwen/Qwen3-8B; hf] 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-0.6B; hf",
)
