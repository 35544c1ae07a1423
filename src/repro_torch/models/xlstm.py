"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

The port of the reference's ``models/xlstm.py``, plain PyTorch as the
reference is plain JAX (no Pallas kernel). The mLSTM runs a whole sequence
in its parallel, attention-like form with log-space stabilised
exponential gating (a row stabiliser ``m`` and a normaliser), and decodes
in its O(1) recurrent form with a matrix memory ``C [Dh, Dh]`` and a
normaliser ``n [Dh]`` per head. The sLSTM is a true scalar recurrence: its
forward steps through the sequence one position at a time (the reference's
``lax.scan`` over time), so a forward of S tokens launches S small steps a
layer.

The head width is ``d_model * ssm_expand / n_heads`` (``_dims``), not
``cfg.head_dim``. ``wif`` and ``w_h`` are float32 whatever the model
dtype, as are the states; the caches are updated in place. The mLSTM's
forward takes its products out of place, so that autograd can keep their
operands (in place saved no peak memory in a [4, 2048] forward).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from .layers import rmsnorm, weight

State = Dict[str, torch.Tensor]


def _dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(d_inner, heads, head dim)."""
    d_in = cfg.d_model * cfg.ssm_expand
    return d_in, cfg.n_heads, d_in // cfg.n_heads


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-x)


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------


def mlstm_init(cfg: ArchConfig, dtype: torch.dtype, device) -> nn.ParameterDict:
    d = cfg.d_model
    d_in, nh, _ = _dims(cfg)
    s = 1.0 / math.sqrt(d)
    return nn.ParameterDict({
        "wq": weight((d, d_in), s, dtype, device),
        "wk": weight((d, d_in), s, dtype, device),
        "wv": weight((d, d_in), s, dtype, device),
        "wif": weight((d, 2 * nh), s, torch.float32, device),  # i, f gate logits
        "wo_gate": weight((d, d_in), s, dtype, device),
        "w_out": weight((d_in, d), 1.0 / math.sqrt(d_in), dtype, device),
        "out_norm": weight((d_in,), None, dtype, device),
    })


def _mlstm_out(p, cfg: ArchConfig, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    h = rmsnorm(h, p["out_norm"], cfg.norm_eps) * F.silu(x @ p["wo_gate"])
    return h @ p["w_out"]


def mlstm_forward(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D], the parallel form."""
    b, s, _ = x.shape
    d_in, nh, hd = _dims(cfg)
    q = (x @ p["wq"]).reshape(b, s, nh, hd).float()
    k = (x @ p["wk"]).reshape(b, s, nh, hd).float()
    v = (x @ p["wv"]).reshape(b, s, nh, hd).float()
    gates = (x.float() @ p["wif"]).reshape(b, s, nh, 2)
    log_i = _log_sigmoid(gates[..., 0])
    logcum_f = torch.cumsum(_log_sigmoid(gates[..., 1]), dim=1)  # [B, S, H]
    # D_ij = logcum_f_i - logcum_f_j + log_i_j for j <= i, -inf above
    dmat = logcum_f[:, :, None, :] - logcum_f[:, None, :, :] + log_i[:, None, :, :]
    above = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
    dmat.masked_fill_(above[None, :, :, None], float("-inf"))
    m = dmat.amax(dim=2, keepdim=True)  # [B, S, 1, H] row stabiliser
    w = torch.einsum("bihd,bjhd->bijh", q, k).div_(math.sqrt(hd))
    w = w * torch.exp(dmat - m)  # [B, S, S, H]; out of place: autograd keeps each factor
    norm = torch.maximum(w.sum(dim=2, keepdim=True).abs(), torch.exp(-m))
    w = w / norm
    h = torch.einsum("bijh,bjhd->bihd", w, v).to(x.dtype)
    return _mlstm_out(p, cfg, h.reshape(b, s, d_in), x)


def mlstm_init_cache(cfg: ArchConfig, batch: int, device) -> State:
    _, nh, hd = _dims(cfg)
    return {
        "c": torch.zeros((batch, nh, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, nh, hd), dtype=torch.float32, device=device),
        "m": torch.full((batch, nh), -1e30, dtype=torch.float32, device=device),
    }


def mlstm_decode(p, cfg: ArchConfig, cache: State, x: torch.Tensor) -> Tuple[torch.Tensor, State]:
    """One token x [B, 1, D], the recurrent form."""
    b = x.shape[0]
    d_in, nh, hd = _dims(cfg)
    q = (x @ p["wq"]).reshape(b, nh, hd).float()
    k = (x @ p["wk"]).reshape(b, nh, hd).float()
    v = (x @ p["wv"]).reshape(b, nh, hd).float()
    gates = (x.float() @ p["wif"]).reshape(b, nh, 2)
    log_i = _log_sigmoid(gates[..., 0])
    log_f = _log_sigmoid(gates[..., 1])
    m_new = torch.maximum(log_f + cache["m"], log_i)  # [B, H]
    f_sc = torch.exp(log_f + cache["m"] - m_new)[..., None]
    i_sc = torch.exp(log_i - m_new)[..., None]
    c, n = cache["c"], cache["n"]
    c.mul_(f_sc[..., None]).add_(i_sc[..., None] * (k[..., :, None] * v[..., None, :]))
    n.mul_(f_sc).add_(i_sc * k)
    cache["m"].copy_(m_new)
    qs = q / math.sqrt(hd)
    num = torch.einsum("bhd,bhde->bhe", qs, c)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qs, n).abs(), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(b, 1, d_in).to(x.dtype)
    return _mlstm_out(p, cfg, h, x), cache


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------


def slstm_init(cfg: ArchConfig, dtype: torch.dtype, device) -> nn.ParameterDict:
    d = cfg.d_model
    d_in, nh, hd = _dims(cfg)
    return nn.ParameterDict({
        # input projections of the (z, i, f, o) gates
        "w_x": weight((d, 4 * d_in), 1.0 / math.sqrt(d), dtype, device),
        # block-diagonal recurrent weights per head: [H, hd, 4 * hd]
        "w_h": weight((nh, hd, 4 * hd), 1.0 / math.sqrt(hd), torch.float32, device),
        "w_out": weight((d_in, d), 1.0 / math.sqrt(d_in), dtype, device),
        "out_norm": weight((d_in,), None, dtype, device),
    })


def slstm_init_cache(cfg: ArchConfig, batch: int, device) -> State:
    _, nh, hd = _dims(cfg)

    def zeros():
        return torch.zeros((batch, nh, hd), dtype=torch.float32, device=device)
    return {"c": zeros(), "n": zeros(), "h": zeros(),
            "m": torch.full((batch, nh, hd), -1e30, dtype=torch.float32, device=device)}


def _slstm_cell(p, cfg: ArchConfig, carry: State, xt: torch.Tensor) -> State:
    """One step. xt [B, 4 * d_in]: the input's projected gate contributions."""
    _, nh, hd = _dims(cfg)
    c, n, h, m = carry["c"], carry["n"], carry["h"], carry["m"]
    rec = torch.einsum("bhd,hde->bhe", h, p["w_h"]).reshape(-1, nh, 4, hd)
    pre = xt.float().reshape(-1, nh, 4, hd) + rec
    z_t = torch.tanh(pre[:, :, 0])
    i_log = pre[:, :, 1]
    f_log = _log_sigmoid(pre[:, :, 2])
    o_t = torch.sigmoid(pre[:, :, 3])
    m_new = torch.maximum(f_log + m, i_log)
    i_sc = torch.exp(i_log - m_new)
    f_sc = torch.exp(f_log + m - m_new)
    c_new = f_sc * c + i_sc * z_t
    n_new = torch.maximum(f_sc * n + i_sc, torch.exp(-m_new))
    return {"c": c_new, "n": n_new, "h": o_t * c_new / n_new, "m": m_new}


def _slstm_out(p, cfg: ArchConfig, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return rmsnorm(h.to(dtype), p["out_norm"], cfg.norm_eps) @ p["w_out"]


def slstm_forward(p, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D], one cell step a position."""
    b, s, _ = x.shape
    d_in = _dims(cfg)[0]
    xin = x @ p["w_x"]  # [B, S, 4 * d_in]
    carry = slstm_init_cache(cfg, b, x.device)
    hs = []
    for t in range(s):
        carry = _slstm_cell(p, cfg, carry, xin[:, t])
        hs.append(carry["h"])
    return _slstm_out(p, cfg, torch.stack(hs, dim=1).reshape(b, s, d_in), x.dtype)


def slstm_decode(p, cfg: ArchConfig, cache: State, x: torch.Tensor) -> Tuple[torch.Tensor, State]:
    """One token x [B, 1, D]; the cache's four states are overwritten."""
    b = x.shape[0]
    new = _slstm_cell(p, cfg, cache, (x @ p["w_x"])[:, 0])
    for key, t in new.items():
        cache[key].copy_(t)
    return _slstm_out(p, cfg, new["h"].reshape(b, 1, -1), x.dtype), cache
