"""deepseek-v2-236b — DeepSeek-V2 MoE with Multi-head Latent Attention.

[arXiv:2405.04434; hf] 60L d_model=5120 128H d_ff(expert)=1536 vocab=102400,
MoE 160 routed top-6 + 2 shared, MLA kv_lora=512, q_lora=1536,
rope_head_dim=64, nope head_dim=128, v_head_dim=128; first layer dense
(d_ff=12288 per the HF config).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,  # MLA: per-head decompression (kv heads == heads)
    d_ff=12288,  # dense first layer
    vocab_size=102400,
    head_dim=128,
    mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    v_head_dim=128,
    moe=True,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    first_dense_layers=1,
    source="arXiv:2405.04434; hf",
)
