"""qwen2-vl-2b — Qwen2-VL 2B backbone (M-RoPE; vision frontend stubbed).

[arXiv:2409.12191; hf] 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936. input_specs() provides precomputed patch embeddings; the
backbone applies M-RoPE (temporal/height/width rotary sections).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    mrope=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    frontend="vision",
    source="arXiv:2409.12191; hf",
)
