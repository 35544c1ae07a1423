"""GQA/MQA attention (+qk-norm) through the hand-written flash kernel.

The port of the reference's ``models/attention.py``, GQA only. Both modes
call :func:`repro_torch.kernels.flash_attention.flash_attention`:

* ``forward`` — full-sequence prefill: the kernel's causal/window mask
  with ``Lq == Lk`` is the reference's ``_mask_bias(arange(S), arange(S))``;
* ``decode`` — one token against a KV cache kept in the reference's
  ``[B, buf, Hkv, Dh]`` layout, which the kernel reads through strides
  (no transpose copies the cache per step).

The cache is updated in place (the reference returns a new array); its
step position ``pos`` is a Python int, so no step syncs with the device
to read it. Waiting for later slices, and raising here: the sliding-window
ring buffer, M-RoPE and MLA.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.flash_attention import flash_attention
from .layers import apply_rope, rmsnorm, weight


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the attention variants this slice does not port."""
    if cfg.mla:
        raise NotImplementedError("MLA attention (deepseek-v2) is not ported yet: "
                                  "ROADMAP queue A, the LM stack's later slice")
    if cfg.mrope:
        raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet: "
                                  "ROADMAP queue A, the LM stack's later slice")


def gqa_init(cfg: ArchConfig, dtype: torch.dtype, device) -> nn.ParameterDict:
    check_supported(cfg)
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": weight((d, h * hd), s, dtype, device),
        "wk": weight((d, hkv * hd), s, dtype, device),
        "wv": weight((d, hkv * hd), s, dtype, device),
        "wo": weight((h * hd, d), 1.0 / math.sqrt(h * hd), dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = weight((hd,), None, dtype, device)
        p["k_norm"] = weight((hd,), None, dtype, device)
    return nn.ParameterDict(p)


def _qkv(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (x @ p["wk"]).reshape(b, s, hkv, hd)
    v = (x @ p["wv"]).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)  # qk-norm over the head dim
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                layer_window: int = -1) -> torch.Tensor:
    """x [B, S, D], positions [B, S] (``arange(S)`` per row) -> [B, S, D]."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    window = cfg.sliding_window if layer_window < 0 else layer_window
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=cfg.causal, window=window)
    return out.transpose(1, 2).reshape(b, s, -1) @ p["wo"]


def gqa_init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype,
                   device) -> Dict[str, torch.Tensor]:
    if cfg.sliding_window:
        raise NotImplementedError("the sliding-window ring-buffer decode is not ported yet: "
                                  "ROADMAP queue A, the LM stack's later slice")
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, max_len, hkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, hkv, hd), dtype=dtype, device=device),
    }


def gqa_decode(p, cfg: ArchConfig, cache: Dict[str, torch.Tensor], x: torch.Tensor,
               pos: int, layer_window: int = -1) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token x [B, 1, D] at step ``pos``; writes its K/V into the cache
    (in place) and attends over the cache prefix that holds positions
    ``0..pos``. The reference masks the whole buffer with ``slot <= pos``;
    unwritten slots would get logit 0, not -inf, under a plain causal
    mask, so the kernel sees only the written prefix, with the query at
    its last position."""
    if cfg.sliding_window:
        raise NotImplementedError("the sliding-window ring-buffer decode is not ported yet: "
                                  "ROADMAP queue A, the LM stack's later slice")
    b = x.shape[0]
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, cfg, x, posb)
    buf = cache["k"].shape[1]
    slot = min(pos, buf - 1)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    n = min(pos + 1, buf)
    window = cfg.sliding_window if layer_window < 0 else layer_window
    out = flash_attention(q.transpose(1, 2), cache["k"][:, :n].transpose(1, 2),
                          cache["v"][:, :n].transpose(1, 2), causal=cfg.causal, window=window)
    return out.transpose(1, 2).reshape(b, 1, -1) @ p["wo"], cache
