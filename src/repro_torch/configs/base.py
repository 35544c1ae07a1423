"""Architecture config schema + input-shape registry.

Every assigned architecture provides a ``CONFIG`` (exact published numbers)
in its own module; ``registry.get(name)`` loads it. ``SHAPES`` defines the
assigned input-shape set; ``cells()`` enumerates the (arch x shape) dry-run
grid with the documented skips (see DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | audio | hybrid | ssm | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention features
    qk_norm: bool = False
    sliding_window: int = 0  # 0 = full attention
    causal: bool = True
    rope_theta: float = 10000.0
    mrope: bool = False  # M-RoPE (qwen2-vl)
    # MLA (deepseek-v2 family)
    mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 64
    v_head_dim: int = 0  # 0 -> head_dim
    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    moe_capacity_factor: float = 1.25  # Switch-style drop capacity
    # SSM / hybrid / xLSTM
    ssm: bool = False
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_heads: int = 0
    attn_every: int = 0  # hybrid: shared attention block every N ssm blocks
    xlstm: bool = False
    slstm_every: int = 0  # sLSTM block every N (rest mLSTM)
    # MLP style: gated (SwiGLU, 3 matrices) vs plain (GELU, 2 matrices)
    gated_mlp: bool = True
    # modality frontend stub
    frontend: str = "none"  # none | audio | vision
    has_decoder: bool = True  # False: encoder-only (no decode shapes)
    subquadratic: bool = False  # eligible for long_500k
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    source: str = ""  # provenance note

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def resolved_v_head_dim(self) -> int:
        return self.v_head_dim or self.resolved_head_dim

    def scaled(self, **overrides) -> "ArchConfig":
        """A reduced copy for smoke tests (same family/features)."""
        return dataclasses.replace(self, **overrides)

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.xlstm:
            # mLSTM: qkv + gates + out
            d_in = d * self.ssm_expand
            per_layer = d * d_in * 4 + d_in * d + 2 * d
            return emb + self.n_layers * per_layer
        if self.ssm:
            d_in = d * self.ssm_expand
            ssm_layer = d * (2 * d_in) + d_in * self.ssm_conv + d_in * d + 3 * d_in
            n_attn = (self.n_layers // self.attn_every) if self.attn_every else 0
            attn_layer = d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d \
                + 3 * d * self.d_ff
            # zamba2-style shared attention block: ONE set of weights
            return emb + self.n_layers * ssm_layer + (attn_layer if n_attn else 0)
        # attention
        if self.mla:
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * self.n_heads * (hd + self.rope_head_dim)
                + d * (self.kv_lora_rank + self.rope_head_dim)
                + self.kv_lora_rank * self.n_heads * (hd + self.resolved_v_head_dim)
                + self.n_heads * self.resolved_v_head_dim * d
            )
        else:
            attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d
        # mlp
        nm = 3 if self.gated_mlp else 2
        if self.moe:
            moe_layers = self.n_layers - self.first_dense_layers
            dense_mlp = nm * d * self.d_ff
            expert_mlp = nm * d * self.moe_d_ff
            mlp_total = (
                self.first_dense_layers * dense_mlp
                + moe_layers * (self.n_experts + self.n_shared_experts) * expert_mlp
                + moe_layers * d * self.n_experts  # router
            )
            return emb + self.n_layers * attn + mlp_total
        mlp = nm * d * self.d_ff
        return emb + self.n_layers * (attn + mlp)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared only)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        moe_layers = self.n_layers - self.first_dense_layers
        expert_mlp = 3 * d * self.moe_d_ff
        all_experts = moe_layers * self.n_experts * expert_mlp
        active_experts = moe_layers * self.top_k * expert_mlp
        return full - all_experts + active_experts


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "granite-20b",
    "h2o-danube-3-4b",
    "deepseek-coder-33b",
    "qwen3-0.6b",
    "deepseek-v2-236b",
    "kimi-k2-1t-a32b",
    "hubert-xlarge",
    "zamba2-2.7b",
    "xlstm-125m",
    "qwen2-vl-2b",
]


def shape_supported(cfg: ArchConfig, shape: str) -> Tuple[bool, str]:
    """(supported, reason-if-skipped) for one (arch, shape) cell."""
    s = SHAPES[shape]
    if s.kind == "decode" and not cfg.has_decoder:
        return False, "encoder-only arch has no decode step"
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch is O(L^2) at 500k; skipped per spec"
    return True, ""


def cells(arch_ids: Optional[List[str]] = None) -> List[Tuple[str, str, bool, str]]:
    """All (arch, shape, supported, reason) cells in the assignment grid."""
    from .registry import get_config

    out = []
    for a in arch_ids or ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES:
            ok, why = shape_supported(cfg, s)
            out.append((a, s, ok, why))
    return out
