"""Mamba2 (SSD) block in the chunked matrix form.

The port of the reference's ``models/ssm.py``. The selective state-space
recurrence

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t^T ;  y_t = C_t . h_t + D x_t

is evaluated over the whole sequence in the reference's chunked SSD form:
the sequence is cut into chunks of ``lc`` steps; inside a chunk the
contributions are attention-like products under a decay matrix, and the
state is carried from chunk to chunk by a loop over the ``nc`` chunks (the
reference's ``lax.scan``). The recurrence is plain PyTorch, as the
reference's is plain JAX (no Pallas kernel).

Under grad mode the forward's products are taken out of place (autograd
keeps their operands); without it, in place: one ``[B, nc, lc, lc, H]``
float32 tensor fewer at the peak (335 MB of zamba2-2.7b's [4, 2048] bf16
forward on an H100, at the same time; ``chip_smoke.py``'s
``forward_forms``).

Decode keeps O(1) state per layer: the last ``K - 1`` conv frames in the
model dtype and the SSM state ``[B, N, H, P]`` in float32 (N before H, as
the reference lays it out), both updated in place.

``w_dt``, ``a_log``, ``d_skip`` and ``dt_bias`` are float32 whatever the
model dtype, as the reference makes them; ``a_log = log(linspace(1, 16,
H))``, ``d_skip`` ones and ``dt_bias``, ``conv_b`` zeros are set when the
parameters are built (``init`` draws only the scaled normal weights).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from .layers import constant, rmsnorm, weight


def _dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads, head dim, state size)."""
    d_in = cfg.d_model * cfg.ssm_expand
    n_heads = cfg.ssm_heads or max(1, d_in // 128)
    return d_in, n_heads, d_in // n_heads, cfg.ssm_state


def mamba2_init(cfg: ArchConfig, dtype: torch.dtype, device) -> nn.ParameterDict:
    d = cfg.d_model
    d_in, nh, _, ns = _dims(cfg)
    conv_dim = d_in + 2 * ns
    s = 1.0 / math.sqrt(d)
    f32 = torch.float32
    return nn.ParameterDict({
        "w_z": weight((d, d_in), s, dtype, device),
        "w_xbc": weight((d, conv_dim), s, dtype, device),
        "w_dt": weight((d, nh), s, f32, device),
        "conv_w": weight((cfg.ssm_conv, conv_dim), 0.5, dtype, device),
        "conv_b": constant(torch.zeros(conv_dim), dtype, device),
        "a_log": constant(torch.log(torch.linspace(1.0, 16.0, nh)), f32, device),
        "d_skip": constant(torch.ones(nh), f32, device),
        "dt_bias": constant(torch.zeros(nh), f32, device),
        "w_out": weight((d_in, d), 1.0 / math.sqrt(d_in), dtype, device),
        "out_norm": weight((d_in,), None, dtype, device),
    })


def _split_proj(p, x: torch.Tensor):
    """z, xbc in the model dtype; dt in float32 (the reference's ``x @
    w_dt`` promotes to w_dt's float32)."""
    return x @ p["w_z"], x @ p["w_xbc"], x.float() @ p["w_dt"]


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence: xbc [B, S, C], w [K, C]."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu(out + b)


def _gated_out(p, cfg: ArchConfig, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return rmsnorm(y * F.silu(z), p["out_norm"], cfg.norm_eps) @ p["w_out"]


def chunk_len(s: int, chunk: int) -> int:
    """The reference's chunk: ``min(chunk, s)``, halved while it does not
    divide ``s``."""
    lc = min(chunk, s)
    while s % lc:
        lc //= 2
    return lc


def mamba2_forward(p, cfg: ArchConfig, x: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D] over the whole sequence (zero initial state)."""
    b, s, _ = x.shape
    d_in, nh, hp, ns = _dims(cfg)
    z, xbc, dt = _split_proj(p, x)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :d_in].reshape(b, s, nh, hp)
    dt = F.softplus(dt + p["dt_bias"])  # [B, S, H]
    a = -torch.exp(p["a_log"])  # [H] negative decay rates

    lc = chunk_len(s, chunk)
    nc = s // lc
    xs_c = xs.float().reshape(b, nc, lc, nh, hp)
    b_c = xbc[..., d_in:d_in + ns].float().reshape(b, nc, lc, ns)
    c_c = xbc[..., d_in + ns:].float().reshape(b, nc, lc, ns)
    dt_c = dt.reshape(b, nc, lc, nh)

    cum = torch.cumsum(dt_c * a, dim=2)  # [B, nc, lc, H] within-chunk log-decay
    total = cum[:, :, -1]  # [B, nc, H]

    # intra-chunk: L[i, j] = exp(cum_i - cum_j) for j <= i. Above the
    # diagonal cum_i - cum_j > 0 grows to hundreds (exp overflows), so it is
    # masked to -inf before the exp, never multiplied by a 0/1 mask.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B, nc, i, j, H]
    above = torch.ones(lc, lc, dtype=torch.bool, device=x.device).triu(1)
    decay = torch.exp(diff.masked_fill_(above[None, None, :, :, None], float("-inf")))
    scores = torch.einsum("bcin,bcjn->bcij", c_c, b_c)
    if torch.is_grad_enabled():  # autograd keeps exp's output: out of place
        w_ij = decay * scores[..., None] * dt_c[:, :, None, :, :]  # [B, nc, i, j, H]
    else:  # no graph: in place, one [B, nc, lc, lc, H] tensor fewer
        w_ij = decay.mul_(scores[..., None]).mul_(dt_c[:, :, None, :, :])
    y = torch.einsum("bcijh,bcjhp->bcihp", w_ij, xs_c)
    del diff, decay, w_ij

    # inter-chunk: chunk c's state contribution sum_j exp(cum_last - cum_j)
    # dt_j B_j x_j^T, carried over the chunks
    decay_to_end = torch.exp(total[:, :, None, :] - cum)  # [B, nc, lc, H]
    bx = torch.einsum("bcjn,bcjhp->bcnhp", b_c, xs_c * (dt_c * decay_to_end)[..., None])
    state = torch.zeros(b, ns, nh, hp, dtype=torch.float32, device=x.device)
    states_in = []
    for c in range(nc):  # the state entering each chunk
        states_in.append(state)
        state = state * torch.exp(total[:, c])[:, None, :, None] + bx[:, c]
    states_in = torch.stack(states_in, dim=1)  # [B, nc, N, H, P]
    y_inter = torch.einsum("bcin,bcnhp->bcihp", c_c, states_in) * torch.exp(cum)[..., None]

    y = (y + y_inter).reshape(b, s, nh, hp)
    y = y + xs.float() * p["d_skip"][None, None, :, None]
    return _gated_out(p, cfg, y.reshape(b, s, d_in).to(x.dtype), z)


# -- O(1) decode -------------------------------------------------------------


def mamba2_init_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                      device) -> Dict[str, torch.Tensor]:
    """``conv [B, K - 1, conv_dim]`` (model dtype), ``state [B, N, H, P]``
    (float32)."""
    d_in, nh, hp, ns = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in + 2 * ns), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, ns, nh, hp), dtype=torch.float32, device=device),
    }


def mamba2_decode(p, cfg: ArchConfig, cache: Dict[str, torch.Tensor],
                  x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token x [B, 1, D]: shifts its frame into the conv window and
    steps the state, both in place."""
    b = x.shape[0]
    d_in, nh, hp, ns = _dims(cfg)
    z, xbc, dt = _split_proj(p, x)
    frames = torch.cat([cache["conv"], xbc], dim=1)  # [B, K, C]
    conv = F.silu(torch.einsum("bkc,kc->bc", frames, p["conv_w"]) + p["conv_b"])
    xs = conv[:, :d_in].reshape(b, nh, hp).float()
    bvec = conv[:, d_in:d_in + ns].float()
    cvec = conv[:, d_in + ns:].float()
    dt1 = F.softplus(dt[:, 0] + p["dt_bias"])  # [B, H]
    decay = torch.exp(dt1 * -torch.exp(p["a_log"]))
    upd = torch.einsum("bn,bhp->bnhp", bvec, xs * dt1[..., None])
    state = cache["state"]
    state.mul_(decay[:, None, :, None]).add_(upd)
    y = torch.einsum("bn,bnhp->bhp", cvec, state) + xs * p["d_skip"][None, :, None]
    cache["conv"].copy_(frames[:, 1:])
    return _gated_out(p, cfg, y.reshape(b, 1, d_in).to(x.dtype), z), cache
