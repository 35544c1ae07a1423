"""Attention variants through the hand-written flash kernel: GQA/MQA
(+qk-norm, sliding window with its ring-buffer decode, M-RoPE,
bidirectional) and MLA.

The port of the reference's ``models/attention.py``. Every mode calls
:func:`repro_torch.kernels.flash_attention.flash_attention`:

* ``forward`` — full-sequence prefill: the kernel's causal/window mask
  with ``Lq == Lk`` is the reference's ``_mask_bias(arange(S), arange(S))``
  (``cfg.causal = False``: hubert's bidirectional encoder);
* ``decode`` — one token against a KV cache kept in the reference's
  ``[B, buf, Hkv, Dh]`` layout, which the kernel reads through strides
  (no transpose copies the cache per step).

A sliding-window config keeps the reference's ring buffer of ``buf =
min(max_len, window)`` slots, slot ``pos % buf``. Once the ring is full
every slot holds one of the last ``buf`` positions, all inside the window
(``buf <= window``), so the kernel attends over every written slot in
slot order, without a mask: softmax does not depend on the keys' order.

MLA (deepseek-v2) keeps the compressed latent: one ``[B, max_len,
kv_lora + rope]`` buffer per layer, whose ``ckv`` and ``krope`` entries
are views, so a decode step writes one row. Its prefill decompresses per
head and calls the kernel at ``(Dqk, Dv) = (192, 128)``; its decode is
the reference's absorbed form (``absorb=True``, what its
``Model.decode_step`` runs): ``q_nope`` folded through ``W_k`` scores
against the latent directly, one kv head shared by every query head, the
kernel at ``(576, 512)`` with the values a view of the keys' first 512
columns; the context then goes through ``W_v`` and ``wo``. The products
outside the attention stay ``torch`` products, as the reference computes
them outside any Pallas kernel.

The caches are updated in place (the reference returns new arrays); the
step position ``pos`` is a Python int, so no step syncs with the device
to read it.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.flash_attention import flash_attention
from .layers import apply_mrope, apply_rope, mrope_sections, rmsnorm, weight


def _rotate(cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """RoPE, or M-RoPE (positions ``[3, B, S]``) for an M-RoPE config."""
    if cfg.mrope:
        return apply_mrope(x, positions, cfg.rope_theta, mrope_sections(x.shape[-1]))
    return apply_rope(x, positions, cfg.rope_theta)


# --------------------------------------------------------------------------
# GQA
# --------------------------------------------------------------------------


def gqa_init(cfg: ArchConfig, dtype: torch.dtype, device) -> nn.ParameterDict:
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
    return _rotate(cfg, q, positions), _rotate(cfg, k, positions), v


def gqa_forward(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
                layer_window: int = -1) -> torch.Tensor:
    """x [B, S, D], positions [B, S] (``arange(S)`` per row; ``[3, B, S]``
    for M-RoPE) -> [B, S, D]."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    window = cfg.sliding_window if layer_window < 0 else layer_window
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=cfg.causal, window=window)
    return out.transpose(1, 2).reshape(b, s, -1) @ p["wo"]


def gqa_init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype,
                   device) -> Dict[str, torch.Tensor]:
    """``k``, ``v`` of ``[B, buf, Hkv, Dh]``: ``buf = min(max_len, window)``
    slots for a sliding-window config (the ring), ``max_len`` otherwise."""
    hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    buf = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    return {
        "k": torch.zeros((batch, buf, hkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, buf, hkv, hd), dtype=dtype, device=device),
    }


def gqa_decode(p, cfg: ArchConfig, cache: Dict[str, torch.Tensor], x: torch.Tensor,
               pos: int, layer_window: int = -1) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token x [B, 1, D] at step ``pos``; writes its K/V into the cache
    (in place) and attends over the slots that hold positions ``<= pos``.

    Without a sliding window slot ``min(pos, buf - 1)`` is written, as the
    reference's clamped update writes it, and the kernel sees the written
    prefix with the query at its last position: the reference masks the
    whole buffer with ``slot <= pos``, and unwritten slots would get logit
    0, not -inf, under a plain causal mask. With one, slot ``pos % buf`` of
    the ring is written and the kernel sees all ``min(pos + 1, buf)``
    written slots, unmasked (see the module's docstring)."""
    b = x.shape[0]
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.mrope:
        posb = posb[None].expand(3, b, 1)
    q, k, v = _qkv(p, cfg, x, posb)
    buf = cache["k"].shape[1]
    window = cfg.sliding_window if layer_window < 0 else layer_window
    if cfg.sliding_window > 0:
        assert buf <= window, f"a ring of {buf} slots must lie inside the window of {window}"
        slot, window = pos % buf, 0  # every written slot is inside the window
    else:
        slot = min(pos, buf - 1)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    n = min(pos + 1, buf)
    out = flash_attention(q.transpose(1, 2), cache["k"][:, :n].transpose(1, 2),
                          cache["v"][:, :n].transpose(1, 2), causal=cfg.causal, window=window)
    return out.transpose(1, 2).reshape(b, 1, -1) @ p["wo"], cache


# --------------------------------------------------------------------------
# MLA (deepseek-v2)
# --------------------------------------------------------------------------


def mla_init(cfg: ArchConfig, dtype: torch.dtype, device) -> nn.ParameterDict:
    d, h = cfg.d_model, cfg.n_heads
    hd, rhd, vhd = cfg.resolved_head_dim, cfg.rope_head_dim, cfg.resolved_v_head_dim
    qlr, kvlr = cfg.q_lora_rank, cfg.kv_lora_rank
    s = 1.0 / math.sqrt(d)
    return nn.ParameterDict({
        "wq_a": weight((d, qlr), s, dtype, device),
        "q_a_norm": weight((qlr,), None, dtype, device),
        "wq_b": weight((qlr, h * (hd + rhd)), 1.0 / math.sqrt(qlr), dtype, device),
        "wkv_a": weight((d, kvlr + rhd), s, dtype, device),
        "kv_a_norm": weight((kvlr,), None, dtype, device),
        "wkv_b": weight((kvlr, h * (hd + vhd)), 1.0 / math.sqrt(kvlr), dtype, device),
        "wo": weight((h * vhd, d), 1.0 / math.sqrt(h * vhd), dtype, device),
    })


def _mla_qkv(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """(q_nope [B, S, H, hd], q_rope [B, S, H, rhd], c_kv [B, S, kv_lora],
    k_rope [B, S, 1, rhd]), as the reference's ``_mla_qkv``."""
    b, s, _ = x.shape
    h, hd, rhd = cfg.n_heads, cfg.resolved_head_dim, cfg.rope_head_dim
    q = rmsnorm(x @ p["wq_a"], p["q_a_norm"], cfg.norm_eps) @ p["wq_b"]
    q = q.reshape(b, s, h, hd + rhd)
    q_nope, q_rope = q[..., :hd], apply_rope(q[..., hd:], positions, cfg.rope_theta)
    kv = x @ p["wkv_a"]  # [B, S, kv_lora + rhd]
    c_kv = rmsnorm(kv[..., :cfg.kv_lora_rank], p["kv_a_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, cfg.kv_lora_rank:], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_scale(cfg: ArchConfig) -> float:
    return 1.0 / math.sqrt(cfg.resolved_head_dim + cfg.rope_head_dim)


def mla_forward(p, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D]: keys decompressed per head, one kernel call
    with ``[q_nope, q_rope]`` against ``[k_nope, k_rope]`` (Dqk = hd + rhd)
    and values of ``v_head_dim``, scaled ``1/sqrt(hd + rhd)``."""
    b, s, _ = x.shape
    h, hd, rhd = cfg.n_heads, cfg.resolved_head_dim, cfg.rope_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    kvb = p["wkv_b"].reshape(cfg.kv_lora_rank, h, -1)
    k_nope = torch.einsum("bsc,chd->bshd", c_kv, kvb[..., :hd])
    v = torch.einsum("bsc,chd->bshd", c_kv, kvb[..., hd:])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, rhd)], dim=-1)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=cfg.causal, scale=_mla_scale(cfg))
    return out.transpose(1, 2).reshape(b, s, -1) @ p["wo"]


def mla_init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype,
                   device) -> Dict[str, torch.Tensor]:
    """``latent [B, max_len, kv_lora + rope]`` and its two views, ``ckv``
    (the first kv_lora columns: the reference's ``ckv``) and ``krope``
    (the reference's ``krope``)."""
    latent = torch.zeros((batch, max_len, cfg.kv_lora_rank + cfg.rope_head_dim), dtype=dtype,
                         device=device)
    return {"latent": latent, "ckv": latent[..., :cfg.kv_lora_rank],
            "krope": latent[..., cfg.kv_lora_rank:]}


def mla_decode(p, cfg: ArchConfig, cache: Dict[str, torch.Tensor], x: torch.Tensor,
               pos: int) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token x [B, 1, D] at step ``pos`` against the latent cache, in
    the reference's absorbed form: scores ``[q_nope W_k, q_rope] .
    [ckv, krope]`` over one kv head (the latent) shared by every head,
    values ``ckv`` (a view of the keys), scale ``1/sqrt(hd + rhd)``; the
    latent context through ``W_v`` and ``wo``. ``q_nope W_k`` and ``ctx
    W_v`` are taken in float32, as the reference takes them."""
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, posb)
    buf = cache["latent"].shape[1]
    slot = min(pos, buf - 1)  # the reference's clamped update
    cache["ckv"][:, slot] = c_kv[:, 0]
    cache["krope"][:, slot] = k_rope[:, 0, 0]
    n = min(pos + 1, buf)
    kvb = p["wkv_b"].reshape(cfg.kv_lora_rank, h, -1)
    q_eff = torch.einsum("bqhd,chd->bqhc", q_nope.float(), kvb[..., :hd].float())
    q = torch.cat([q_eff.to(x.dtype), q_rope], dim=-1).transpose(1, 2)  # [B, H, 1, kvlr + rhd]
    keys = cache["latent"][:, None, :n]  # [B, 1, n, kvlr + rhd]
    ctx = flash_attention(q, keys, keys[..., :cfg.kv_lora_rank], causal=True,
                          scale=_mla_scale(cfg))  # [B, H, 1, kvlr]
    out = torch.einsum("bhqc,chd->bqhd", ctx.float(), kvb[..., hd:].float())
    return out.to(x.dtype).reshape(b, 1, -1) @ p["wo"], cache
