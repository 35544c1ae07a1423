"""Architecture registry: --arch <id> -> ArchConfig."""
from __future__ import annotations

import importlib
from typing import Dict

from .base import ARCH_IDS, ArchConfig

_MOD = {
    "granite-20b": "granite_20b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen3-0.6b": "qwen3_0_6b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "hubert-xlarge": "hubert_xlarge",
    "zamba2-2.7b": "zamba2_2_7b",
    "xlstm-125m": "xlstm_125m",
    "qwen2-vl-2b": "qwen2_vl_2b",
}


def get_config(name: str) -> ArchConfig:
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MOD)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[name]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    cfg = get_config(name)
    kw = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
    )
    if cfg.mla:
        kw.update(kv_lora_rank=64, q_lora_rank=96, rope_head_dim=16, head_dim=32, v_head_dim=32)
    if cfg.moe:
        kw.update(n_experts=8, top_k=2, moe_d_ff=128,
                  n_shared_experts=min(cfg.n_shared_experts, 1),
                  first_dense_layers=min(cfg.first_dense_layers, 1))
    if cfg.ssm:
        kw.update(ssm_state=16, ssm_heads=4, attn_every=cfg.attn_every and 2)
        kw.update(n_layers=4)
    if cfg.xlstm:
        kw.update(n_layers=4, slstm_every=cfg.slstm_every and 4)
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    return cfg.scaled(**kw)
