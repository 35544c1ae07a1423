"""hubert-xlarge — HuBERT X-Large audio encoder (encoder-only).

[arXiv:2106.07447; unverified] 48L d_model=1280 16H (kv=16) d_ff=5120
vocab=504 (cluster targets). Encoder-only: no decode shapes. The audio
frontend (conv feature extractor) is a STUB: input_specs() provides
precomputed frame embeddings.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    head_dim=80,
    gated_mlp=False,  # standard transformer-encoder MLP
    causal=False,
    has_decoder=False,
    frontend="audio",
    source="arXiv:2106.07447; unverified",
)
