"""Mixture-of-Experts layer, dispatched through the hand-written gather.

The port of the reference's ``models/moe.py``, with its semantics kept
exactly (group count, per-group capacity, stable expert sort, drops):

1. route: softmax in float32, top-k, renormalise by ``max(sum, 1e-9)``;
2. sort each group's ``Tg * k`` assignments by expert id (stable, as
   ``jnp.argsort`` is), so an overflowing expert keeps the same tokens;
3. bin them into ``[G, E, C, D]`` capacity bins: the kernel
   :func:`repro_torch.kernels.moe_dispatch.moe_gather` gathers each
   expert's run of sorted assignments straight from the token table, so
   the ``[Tg * k, D]`` sorted-token tensor is never written;
4. run the per-expert FFN as batched matrix products;
5. combine: each token sums its ``k`` weighted expert outputs in a fixed
   order, in ``x.dtype``. The reference scatter-adds; on the card a
   scatter-add in bf16 goes through atomics whose order changes from run
   to run, so the port gathers per token instead and two runs give the
   same bits.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig
from ..kernels.moe_dispatch import moe_gather
from .layers import weight


def moe_init(cfg: ArchConfig, dtype: torch.dtype, device) -> nn.ParameterDict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {
        "router": weight((d, e), s_in, torch.float32, device),
        "wi": weight((e, d, f), s_in, dtype, device),
        "wg": weight((e, d, f), s_in, dtype, device),
        "wo": weight((e, f, d), s_out, dtype, device),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_wi"] = weight((d, fs), s_in, dtype, device)
        p["shared_wg"] = weight((d, fs), s_in, dtype, device)
        p["shared_wo"] = weight((fs, d), s_out, dtype, device)
    return nn.ParameterDict(p)


def _dispatch_groups(t: int, max_groups: int = 32) -> int:
    """Largest power-of-two group count <= max_groups dividing t (the
    reference's data-parallel dispatch groups; capacity is per group)."""
    g = 1
    while g * 2 <= max_groups and t % (g * 2) == 0 and t // (g * 2) >= 1:
        g *= 2
    return g


def route(top_e: torch.Tensor, n_experts: int, cap: int):
    """The dispatch plan of ``top_e [G, Tg, k]`` (each token's experts):
    ``se, order`` — the ``Tg * k`` assignments of each group sorted by
    expert (stable, as ``jnp.argsort`` is), ``order`` holding assignment
    ``token * k + j``; ``offsets [G, E]`` — where expert ``e``'s run starts
    in that order; ``sizes [G, E]`` — its live slots, ``min(count, cap)``."""
    g = top_e.shape[0]
    se, order = torch.sort(top_e.reshape(g, -1), dim=-1, stable=True)
    counts = torch.zeros((g, n_experts), dtype=torch.int64, device=top_e.device)
    counts.scatter_add_(1, se, torch.ones_like(se))
    offsets = torch.cumsum(counts, dim=1) - counts
    return se, order, offsets, counts.clamp(max=cap)


def moe_apply(p, cfg: ArchConfig, x: torch.Tensor, capacity_factor: float = 0.0,
              n_groups: int = 0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, D] -> ([B, S, D], aux) with aux ``load_balance_loss`` and
    ``drop_fraction`` (0-d float32 tensors)."""
    capacity_factor = capacity_factor or cfg.moe_capacity_factor
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    g = n_groups or _dispatch_groups(t)
    tg = t // g
    xt = x.reshape(g, tg, d)

    # 1. route
    logits = xt.float() @ p["router"]  # [G, Tg, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)  # [G, Tg, k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # 2.-3. shuffle routing and per-group capacity binning
    cap = int(max(1, math.ceil(capacity_factor * tg * k / e)))
    se, order, offsets, sizes = route(top_e, e, cap)
    binned = moe_gather(xt, offsets.to(torch.int32), sizes.to(torch.int32), cap,
                        rows=(order // k).to(torch.int32))

    # 4. per-expert FFN (batched matrix products over the experts)
    hi = torch.einsum("gecd,edf->gecf", binned, p["wi"])
    hg = torch.einsum("gecd,edf->gecf", binned, p["wg"])
    y = torch.einsum("gecf,efd->gecd", F.silu(hg) * hi, p["wo"])  # [G, E, C, D]

    # 5. weighted combine, gathered per token over its k assignments
    pos_in_e = torch.arange(tg * k, device=x.device) - offsets.gather(1, se)
    keep = pos_in_e < cap  # [G, Tg*k] in sorted order
    inv = torch.empty_like(order)
    inv.scatter_(1, order, torch.arange(tg * k, device=x.device).expand(g, -1))
    keep_a = keep.gather(1, inv).reshape(g, tg, k)  # assignment order
    slot_a = (se * cap + pos_in_e).gather(1, inv).reshape(g, tg, k)
    slot_a = torch.where(keep_a, slot_a, torch.zeros_like(slot_a))
    flat_y = y.reshape(g, e * cap, d)
    w = top_p.to(x.dtype)
    out = torch.zeros((g, tg, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        yj = flat_y.gather(1, slot_a[:, :, j, None].expand(g, tg, d))
        out = out + torch.where(keep_a[:, :, j, None], yj * w[:, :, j, None],
                                torch.zeros((), dtype=x.dtype, device=x.device))

    # shared experts (always on)
    if cfg.n_shared_experts:
        hs = F.silu(xt @ p["shared_wg"]) * (xt @ p["shared_wi"])
        out = out + (hs @ p["shared_wo"]).to(out.dtype)

    # aux metrics: load balance + drop fraction
    me = probs.mean(dim=(0, 1))  # [E] router prob mass
    ce = F.one_hot(top_e[..., 0], e).float().mean(dim=(0, 1))  # top-1 assignment share
    aux = {
        "load_balance_loss": e * torch.sum(me * ce),
        "drop_fraction": 1.0 - keep.float().mean(),
    }
    return out.reshape(b, s, d), aux
