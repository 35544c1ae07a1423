"""Shared layer primitives: norms, MLPs, RoPE.

The port of the reference's ``models/layers.py`` (RoPE and Qwen2-VL's
M-RoPE included) without its sharding
rules (``shd`` is a no-op outside a mesh) and the abstract-init context
of its dry run; qk-norm is ``rmsnorm`` over the head dim and the
embedding lookup an index. Weights keep the reference's names, shapes
and orientation (``x @ w``) so that :mod:`.convert` carries them across
one to one. Casts happen where the reference casts them: norms and RoPE
compute in float32 and cast back to the input dtype.

Every weight is an ``nn.Parameter`` that carries its init scale
(``init_scale``: normal draws times the scale, or ``None`` for a norm's
ones and the other constants); :func:`init_normal_` fills it in slices so that a full-width
expert tensor never has a float32 temporary of its own size.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

#: largest float32 temporary drawn at once by :func:`init_normal_`
INIT_CHUNK_ELEMS = 1 << 26


def weight(shape, scale: Optional[float], dtype: torch.dtype, device) -> nn.Parameter:
    """An uninitialised weight that :func:`init_normal_` fills with
    ``N(0, 1) * scale``; ``scale=None`` is a norm weight, set to ones."""
    if scale is None:
        t = torch.ones(shape, dtype=dtype, device=device)
    else:
        t = torch.empty(shape, dtype=dtype, device=device)
    p = nn.Parameter(t, requires_grad=False)
    p.init_scale = scale
    return p


def constant(values: torch.Tensor, dtype: torch.dtype, device) -> nn.Parameter:
    """A weight set to ``values`` when it is built, which :func:`init_normal_`
    never draws (the reference's constant initial values: zeros, ones, a
    ramp of decay rates)."""
    p = nn.Parameter(values.to(device=device, dtype=dtype), requires_grad=False)
    p.init_scale = None
    return p


@torch.no_grad()
def init_normal_(p: torch.Tensor, scale: float, generator: torch.Generator) -> torch.Tensor:
    """Fill ``p`` with float32 normal draws times ``scale``, cast to p's
    dtype (the reference's ``_init_normal``), drawing slices of the
    leading dim so that no temporary exceeds ``INIT_CHUNK_ELEMS``."""
    flat = p.view(p.shape[0], -1) if p.dim() > 1 else p.view(1, -1)
    rows = max(1, INIT_CHUNK_ELEMS // max(1, flat.shape[1]))
    for r0 in range(0, flat.shape[0], rows):
        part = flat[r0:r0 + rows]
        draw = torch.randn(part.shape, generator=generator, device=p.device,
                           dtype=torch.float32)
        part.copy_(draw.mul_(scale))
    return p


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


# --------------------------------------------------------------------------
# MLP (gated SwiGLU or plain GELU)
# --------------------------------------------------------------------------


def mlp_init(d: int, ff: int, gated: bool, dtype: torch.dtype, device) -> nn.ParameterDict:
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    p = {"wi": weight((d, ff), s_in, dtype, device)}
    if gated:
        p["wg"] = weight((d, ff), s_in, dtype, device)
    p["wo"] = weight((ff, d), s_out, dtype, device)
    return nn.ParameterDict(p)


def mlp_apply(p, x: torch.Tensor, gated: bool) -> torch.Tensor:
    h = x @ p["wi"]
    if gated:
        h = F.silu(x @ p["wg"]) * h
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return h @ p["wo"]


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, S, H, Dh], positions [B, S]: rotate the two halves of Dh."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # [Dh/2]
    angles = positions[..., None].float() * freqs  # [B, S, Dh/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: x [B, S, H, Dh], positions [3, B, S]
    (the t, h and w position ids); the rotary half of Dh is cut into
    ``sections`` of frequencies, section ``i`` rotated by position source
    ``i``."""
    dh = x.shape[-1]
    half = dh // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} must cover head_dim/2 = {half}")
    freqs = rope_freqs(dh, theta, x.device)  # [half]
    sec_id = torch.cat([torch.full((n,), i, dtype=torch.long, device=x.device)
                        for i, n in enumerate(sections)])  # [half]
    pos_per_freq = positions.float()[sec_id]  # [half, B, S]
    angles = pos_per_freq.permute(1, 2, 0) * freqs  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """Qwen2-VL's default sections scaled to head_dim (16/24/24 at Dh 128)."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return t, h, half - t - h
