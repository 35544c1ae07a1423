"""h2o-danube-3-4b — H2O.ai Danube3 (llama+mistral mix, sliding window).

[arXiv:2401.16818; unverified] 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000. SWA window 4096 (mistral-style) -> sub-quadratic; runs long_500k.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,
    sliding_window=4096,
    subquadratic=True,
    source="arXiv:2401.16818; unverified",
)
