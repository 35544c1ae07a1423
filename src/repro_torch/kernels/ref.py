"""Plain PyTorch versions of the hand-written kernels.

Each function here defines what its kernel computes. The wrappers in
:mod:`.shuffle_reduce`, :mod:`.edge_stream`, :mod:`.flash_attention` and
:mod:`.moe_dispatch` run these for tensors that lie on the CPU; the tests and ``chip_smoke.py`` hold each kernel against
its plain version. They repeat the kernel's arithmetic and are no
yardstick of speed.

The batched forms (``*_batched_ref``) reduce ``K`` rows over one bin
layout: row ``k``'s bins are ``k * n_out .. (k + 1) * n_out - 1`` of one
flattened scatter, which keeps each bin's updates in stream order, so a
row gives the same bits as the one-row version on the CPU.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

_OPS = ("+", "min", "max", "|")
_APPLY = ("add", "mul", "src")


def identity(op: str, dtype: torch.dtype):
    """The reduction identity a bin holds when no update reaches it."""
    if op == "+":
        return False if dtype == torch.bool else 0
    if op == "min":
        if dtype.is_floating_point:
            return float("inf")
        return torch.iinfo(dtype).max
    if op == "max":
        if dtype.is_floating_point:
            return float("-inf")
        return torch.iinfo(dtype).min
    if op == "|":
        if dtype != torch.int32:
            raise TypeError(f"the bitwise-OR reduce takes int32, not {dtype}")
        return 0
    raise ValueError(f"no identity for reduce op {op!r}")


def _scatter_or(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``out[idx[i]] |= vals[i]``. PyTorch has no OR scatter-reduce, so each
    of the 32 bits is reduced on its own with ``amax`` (exact) and the bits
    are packed again."""
    idx = idx.long()
    packed = torch.zeros_like(out)
    for b in range(32):
        bit = torch.bitwise_right_shift(vals, b) & 1
        red = (torch.bitwise_right_shift(out, b) & 1).scatter_reduce_(0, idx, bit, "amax")
        packed |= torch.bitwise_left_shift(red, b)
    return out.copy_(packed)


def _scatter(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor, op: str):
    if op == "+":
        return out.index_add_(0, idx, vals)
    if op in ("min", "max"):
        return out.scatter_reduce_(0, idx.long(), vals, "a" + op, include_self=True)
    if op == "|":
        return _scatter_or(out, idx, vals)
    raise ValueError(op)


def shuffle_reduce_ref(vals: torch.Tensor, idx: torch.Tensor, n_out: int,
                       op: str) -> torch.Tensor:
    """Scatter-reduce ``vals`` into ``n_out`` bins; identity elsewhere.

    Indices outside ``[0, n_out)`` are dropped (the padding convention).
    """
    if op not in _OPS:
        raise ValueError(op)
    ident = identity(op, vals.dtype)
    out = torch.full((n_out,), ident, dtype=vals.dtype, device=vals.device)
    ok = (idx >= 0) & (idx < n_out)
    safe_idx = torch.where(ok, idx, torch.zeros_like(idx))
    safe_vals = torch.where(ok, vals, torch.full_like(vals, ident))
    return _scatter(out, safe_idx, safe_vals, op)


def bin_ids(offsets: torch.Tensor) -> torch.Tensor:
    """Bin id of every position in ``[offsets[0], offsets[-1])``."""
    n_out = offsets.shape[0] - 1
    counts = offsets[1:] - offsets[:-1]
    bins = torch.arange(n_out, dtype=torch.int32, device=offsets.device)
    total = int(offsets[-1] - offsets[0]) if n_out > 0 else 0
    return torch.repeat_interleave(bins, counts, output_size=total)


def segment_reduce_ref(vals_sorted: torch.Tensor, offsets: torch.Tensor,
                       op: str) -> torch.Tensor:
    """Reduce a bin-sorted stream: bin ``b`` covers
    ``vals_sorted[offsets[b]:offsets[b+1]]``; empty bins hold the
    identity. Positions outside ``[offsets[0], offsets[-1])`` are not
    read, and offsets are clamped into ``[0, len(vals_sorted)]``, as the
    kernels clamp them."""
    offsets = offsets.clamp(0, vals_sorted.shape[0])
    n_out = offsets.shape[0] - 1
    lo = int(offsets[0]) if n_out > 0 else 0
    ids = bin_ids(offsets)
    seg = vals_sorted[lo:lo + ids.shape[0]]
    return shuffle_reduce_ref(seg, ids, n_out, op)


def row_bins(ids: torch.Tensor, k: int, n_out: int) -> torch.Tensor:
    """Row ``r``'s bin ``b`` -> ``r * n_out + b`` for ``ids`` of ``[n]``
    (shared by the rows) or ``[k, n]``; a bin outside ``[0, n_out)`` maps to
    -1, so that it is dropped and never lands in the next row's bins."""
    ids = torch.broadcast_to(ids, (k, ids.shape[-1]))
    base = torch.arange(k, dtype=ids.dtype, device=ids.device)[:, None] * n_out
    return torch.where((ids >= 0) & (ids < n_out), ids + base, -1).reshape(-1)


def shuffle_reduce_batched_ref(vals: torch.Tensor, idx: torch.Tensor, n_out: int,
                               op: str) -> torch.Tensor:
    """Row ``k`` of ``[K, N]`` values scatter-reduced into ``n_out`` bins by
    ``idx`` (``[N]`` shared by the rows, or ``[K, N]``): ``[K, n_out]``."""
    k = vals.shape[0]
    return shuffle_reduce_ref(vals.reshape(-1), row_bins(idx, k, n_out), k * n_out,
                              op).view(k, n_out)


def segment_reduce_batched_ref(vals_sorted: torch.Tensor, offsets: torch.Tensor,
                               op: str) -> torch.Tensor:
    """:func:`segment_reduce_ref` of each row of ``[K, N]`` values over one
    ``offsets``: ``[K, n_out]``."""
    offsets = offsets.clamp(0, vals_sorted.shape[1])
    n_out = offsets.shape[0] - 1
    lo = int(offsets[0]) if n_out > 0 else 0
    ids = bin_ids(offsets)
    seg = vals_sorted[:, lo:lo + ids.shape[0]]
    return shuffle_reduce_batched_ref(seg, ids, n_out, op)


def _apply(apply_op: str, sv: torch.Tensor, w):
    if apply_op == "add":
        return sv + w
    if apply_op == "mul":
        return sv * w
    if apply_op == "src":
        return sv
    raise ValueError(apply_op)


def edge_stream_ref(
    src_vals: torch.Tensor,  # [E] gathered source-side operand
    weights: torch.Tensor,  # [E] edge weights (or ones)
    dst: torch.Tensor,  # [E] destination ids
    active: torch.Tensor,  # [E] bool frontier mask
    n_out: int,
    apply_op: str,  # 'add' | 'mul' | 'src' (ignore weight)
    reduce_op: str,  # '+' | 'min' | 'max'
) -> torch.Tensor:
    """Fused edge pipeline: apply(src_val, w) masked by the frontier,
    reduced by dst."""
    upd = _apply(apply_op, src_vals, weights)
    upd = torch.where(active, upd, torch.full_like(upd, identity(reduce_op, upd.dtype)))
    return shuffle_reduce_ref(upd, dst, n_out, reduce_op)


def edge_stream_gather_ref(
    vval: torch.Tensor,  # [V] vertex-side operand
    vact: torch.Tensor,  # [V] bool vertex mask
    src_s: torch.Tensor,  # [E'] source vertex of each edge, edges sorted by bin
    eid_s: torch.Tensor,  # [E'] edge id of each sorted edge (weight index)
    weights,  # [E] edge weights by edge id, or None for apply 'src'
    offsets: torch.Tensor,  # [n_out + 1] bin ranges into the sorted edges
    apply_op: str,
    reduce_op: str,
) -> torch.Tensor:
    """The fused-gather form: per sorted edge ``e``, ``s = src_s[e]`` and
    ``upd = vact[s] ? apply(vval[s], weights[eid_s[e]]) : identity``;
    bin ``b`` reduces ``offsets[b]:offsets[b+1]``."""
    sv = vval[src_s]
    w = weights[eid_s] if apply_op != "src" else None
    upd = _apply(apply_op, sv, w)
    upd = torch.where(vact[src_s], upd, torch.full_like(upd, identity(reduce_op, upd.dtype)))
    return segment_reduce_ref(upd, offsets, reduce_op)


def edge_stream_batched_ref(src_vals, weights, dst, active, n_out: int, apply_op: str,
                            reduce_op: str) -> torch.Tensor:
    """:func:`edge_stream_ref` of each row of ``[K, E]`` source values;
    ``weights`` and ``active`` are ``[E]`` (shared) or ``[K, E]``, ``dst``
    ``[E]``."""
    upd = _apply(apply_op, src_vals, weights)
    upd = torch.where(active, upd, torch.full_like(upd, identity(reduce_op, upd.dtype)))
    return shuffle_reduce_batched_ref(upd, dst, n_out, reduce_op)


def edge_stream_gather_batched_ref(vval, vact, src_s, eid_s, weights, offsets, apply_op: str,
                                   reduce_op: str) -> torch.Tensor:
    """:func:`edge_stream_gather_ref` of each row of ``[K, V]`` vertex
    values; ``vact`` is ``[V]`` (shared) or ``[K, V]``, ``weights`` ``[E]``
    (shared) or ``[K, E]``; the sorted edges and ``offsets`` serve every
    row."""
    sv = vval.index_select(-1, src_s)
    w = weights.index_select(-1, eid_s) if apply_op != "src" else None
    upd = _apply(apply_op, sv, w)
    act = torch.broadcast_to(vact.index_select(-1, src_s), upd.shape)
    upd = torch.where(act, upd, torch.full_like(upd, identity(reduce_op, upd.dtype)))
    return segment_reduce_batched_ref(upd, offsets, reduce_op)


def flash_attention_ref(
    q: torch.Tensor,  # [B, H, Lq, Dqk]
    k: torch.Tensor,  # [B, Hkv, Lk, Dqk]
    v: torch.Tensor,  # [B, Hkv, Lk, Dv]
    causal: bool = True,
    window: int = 0,  # 0 = full; > 0 = sliding window
    scale: Optional[float] = None,  # None = 1/sqrt(Dqk)
) -> torch.Tensor:
    """Softmax attention in float32, output ``[B, H, Lq, Dv]`` in q's dtype.

    Scale ``1/sqrt(Dqk)`` unless given; query ``i`` sits at position ``Lk - Lq + i``
    (decode alignment); causal keeps keys ``<=`` the query position, a
    window keeps keys ``>`` position ``- window``; kv head ``h // (H / Hkv)``
    serves query head ``h`` (GQA). A row whose keys are all masked comes
    out 0: the softmax denominator is clamped at ``1e-30``, as the kernel
    clamps it, where a plain softmax would give NaN.
    """
    b, h, lq, dh = q.shape
    hkv = k.shape[1]
    if h % hkv:
        raise ValueError(f"flash_attention: {h} query heads over {hkv} kv heads")
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    p, denom = _softmax_parts(q, k, causal, window, scale)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(p.dtype)) / denom
    return out.to(q.dtype)


def _softmax_parts(q, k, causal: bool, window: int, scale: float):
    """``(exp(logits - rowmax), denominator)`` of the attention of ``q [B, H,
    Lq, D]`` over ``k [B, H, Lk, D]`` (kv heads already repeated), in float32
    (float64 for float64 inputs): masked logits are -inf, a row with no key
    has max 0, the denominator is clamped at 1e-30."""
    lq, lk = q.shape[2], k.shape[2]
    ct = torch.promote_types(q.dtype, torch.float32)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), k.to(ct)) * scale
    q_pos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
    k_pos = torch.arange(lk, device=q.device)[None, :]
    mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    return p, p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def flash_attention_bwd_ref(q, k, v, out, dout, causal: bool = True, window: int = 0,
                            scale: Optional[float] = None):
    """``(dq, dk, dv)``: the gradient of :func:`flash_attention_ref` at ``(q,
    k, v)`` for the output gradient ``dout [B, H, Lq, Dv]``, given the
    forward's output ``out``, by the explicit formula (no autograd), in
    float32 (float64 for float64 inputs): ``P`` recomputed, ``dV = P^T dO``,
    ``dP = dO V^T``, ``dS = P o (dP - rowsum(dO o O))``, ``dQ = scale dS
    K``, ``dK = scale dS^T Q``, the query heads of each kv head summed into
    its dK and dV. Each gradient in its input's dtype and shape."""
    b, h, lq, dqk = q.shape
    hkv = k.shape[1]
    group = h // hkv
    scale = 1.0 / math.sqrt(dqk) if scale is None else scale
    kr, vr = k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1)
    p, denom = _softmax_parts(q, kr, causal, window, scale)
    p = p / denom
    ct = p.dtype
    g = dout.to(ct)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, vr.to(ct))
    ds = p * (dp - (g * out.to(ct)).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr.to(ct)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(ct)) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
    dk = dk.reshape(b, hkv, group, *dk.shape[2:]).sum(dim=2)
    dv = dv.reshape(b, hkv, group, *dv.shape[2:]).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _fold_partials(parts, rescale: bool = True):
    """Fold partial ``(m, l, acc)`` states in list order into one: each
    weighted by ``exp(m_part - m)`` (0 for a part that saw no key) against
    the largest ``m``. ``rescale=False`` weights every live part 1 (a fault:
    the parts' maxima are then mixed)."""
    m = torch.stack([p[0] for p in parts]).amax(dim=0)
    l_sum = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for mp, lp, ap in parts:
        live = mp > float("-inf")
        w = torch.exp(mp - m) if rescale else torch.ones_like(m)
        w = torch.where(live, w, torch.zeros_like(w))
        l_sum = l_sum + lp * w
        acc = acc + ap * w[..., None]
    return m, l_sum, acc


def flash_attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = True, window: int = 0, *, n_splits: int,
                              chunk: int, teams: int, unit: int,
                              rescale: bool = True,
                              scale: Optional[float] = None) -> torch.Tensor:
    """The decode route's schedule (``csrc/flash_attention.cu``,
    ``flash_decode_kernel`` and its combine) in plain PyTorch, for the
    tests: what :func:`flash_attention_ref` computes, taken in the
    kernel's order. Split ``s`` holds keys ``[s * chunk, (s + 1) * chunk)``
    (cut at ``Lk``); in it, team ``t`` of ``teams`` folds keys ``s * chunk
    + t``, ``+ teams``, ... in that order, ``unit`` at a time, into its own
    running ``(m, l, acc)``; the teams' states are folded in team order,
    then the splits' in split order, and ``acc`` is divided by ``l``
    clamped at ``1e-30``. ``rescale=False`` folds the splits without their
    ``exp(m_s - m)`` weights: the fault control of ``chip_smoke.py``."""
    b, h, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
    k_pos = torch.arange(lk, device=q.device)[None, :]
    mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    vf = v.float()
    neg = torch.full((b, h, lq), float("-inf"), device=q.device)
    zero_acc = torch.zeros(b, h, lq, v.shape[-1], device=q.device)
    splits = []
    for s in range(n_splits):
        s0, s1 = s * chunk, min(lk, (s + 1) * chunk)
        parts = []
        for t in range(teams):
            keys = torch.arange(s0 + t, max(s0 + t, s1), teams, device=q.device)
            m, l_sum, acc = neg, torch.zeros_like(neg), zero_acc
            for u in range(0, keys.numel(), unit):
                kk = keys[u:u + unit]
                sc = logits[..., kk]
                live = sc.amax(dim=-1) > float("-inf")  # the row sees a key of this unit
                m_new = torch.where(live, torch.maximum(m, sc.amax(dim=-1)), m)
                alpha = torch.where(live, torch.exp(m - m_new), torch.ones_like(m))
                p = torch.where(sc > float("-inf"), torch.exp(sc - m_new[..., None]),
                                torch.zeros_like(sc))
                l_sum = l_sum * alpha + p.sum(dim=-1)
                acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vf[..., kk, :])
                m = m_new
            parts.append((m, l_sum, acc))
        splits.append(_fold_partials(parts))
    _, l_sum, acc = _fold_partials(splits, rescale)
    return (acc / l_sum.clamp_min(1e-30)[..., None]).to(q.dtype)


def flash_attention_tile_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool = True, window: int = 0, *, bm: int, bn: int,
                             rescale: bool = True,
                             scale: Optional[float] = None) -> torch.Tensor:
    """The float32 tile route's schedule in plain PyTorch, for the CPU
    tests: what :func:`flash_attention_ref` computes, taken in the kernel's
    steps. A kv head's ``group x Lq`` query rows are numbered
    position-major (row ``g``: head ``g % group`` of the group, position
    ``g // group``) and cut into tiles of ``bm``; each tile walks the key
    tiles of ``bn`` keys that ``flash_attention.key_tiles`` lists, masking
    key by key only in those not inside every row's keys, and folds each
    into its rows' running ``(m, l, acc)``: the tile's max, the rescale of
    ``l`` and ``acc`` by ``exp(m_old - m_new)``, then ``P`` and ``P V``; a
    row that sees no key comes out 0. ``rescale=False`` leaves out the
    rescale (a fault: tiles taken against different maxima are mixed), the
    fault control of ``chip_smoke.py``."""
    from .flash_attention import key_tiles  # the wrapper imports this module

    b, h, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    group, rows = h // hkv, h // hkv * lq
    qf = q.float().reshape(b, hkv, group, lq, dh).transpose(2, 3).reshape(b, hkv, rows, dh)
    kf, vf = k.float(), v.float()
    q_pos = torch.arange(rows, device=q.device) // group + (lk - lq)
    dv = v.shape[-1]
    out = torch.zeros(b, hkv, rows, dv, device=q.device)
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    for tile in range(-(-rows // bm)):
        r0, r1 = tile * bm, min((tile + 1) * bm, rows)
        qt, qp = qf[:, :, r0:r1], q_pos[r0:r1, None]
        m = torch.full((b, hkv, r1 - r0), float("-inf"), device=q.device)
        l_sum = torch.zeros_like(m)
        acc = torch.zeros(b, hkv, r1 - r0, dv, device=q.device)
        for t, inside in key_tiles(tile, bm, bn, rows, group, lq, lk, causal, window):
            k0, k1 = t * bn, min((t + 1) * bn, lk)
            sc = torch.einsum("bhqd,bhkd->bhqk", qt, kf[:, :, k0:k1]) * scale
            if not inside:
                kp = torch.arange(k0, k1, device=q.device)[None, :]
                ok = torch.ones(r1 - r0, k1 - k0, dtype=torch.bool, device=q.device)
                if causal:
                    ok &= kp <= qp
                if window > 0:
                    ok &= kp > qp - window
                sc = sc.masked_fill(~ok, float("-inf"))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            m_use = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
            alpha = torch.exp(m - m_use) if rescale else torch.ones_like(m)
            p = torch.exp(sc - m_use[..., None])
            l_sum = l_sum * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vf[:, :, k0:k1])
            m = m_new
        out[:, :, r0:r1] = acc / l_sum.clamp_min(1e-30)[..., None]
    return out.reshape(b, hkv, lq, group, dv).transpose(2, 3).reshape(b, h, lq, dv).to(q.dtype)


def moe_gather_ref(
    tokens: torch.Tensor,  # [G, T, D] token table of each group
    rows: Optional[torch.Tensor],  # [G, R] token row of each stream slot, or None
    offsets: torch.Tensor,  # [G, E] first stream slot of each expert
    sizes: torch.Tensor,  # [G, E] live slots of each expert (<= capacity)
    capacity: int,
) -> torch.Tensor:
    """Capacity-binned expert gather: ``[G, E, C, D]`` with
    ``out[g, e, c] = tokens[g, rows[g, offsets[g, e] + c]]`` for
    ``c < sizes[g, e]`` and zeros elsewhere (``rows=None``: the stream is
    the token table itself, ``rows[g, s] = s``). Stream slots are clamped
    into ``[0, R)`` and token rows into ``[0, T)``, as the kernel clamps
    them."""
    g, t, d = tokens.shape
    e = offsets.shape[1]
    n_stream = t if rows is None else rows.shape[1]
    c = torch.arange(capacity, device=tokens.device)
    slot = (offsets.long()[..., None] + c).clamp(0, max(n_stream - 1, 0))  # [G, E, C]
    row = slot if rows is None else rows.long().gather(1, slot.reshape(g, -1)).reshape(slot.shape)
    row = row.clamp(0, max(t - 1, 0))
    out = tokens[torch.arange(g, device=tokens.device)[:, None], row.reshape(g, -1)]
    live = (c < sizes.long()[..., None]).reshape(g, e * capacity, 1)
    return torch.where(live, out, torch.zeros((), dtype=tokens.dtype,
                                              device=tokens.device)).reshape(g, e, capacity, d)


def moe_gather_inverse(offsets: torch.Tensor, sizes: torch.Tensor, rows: Optional[torch.Tensor],
                       capacity: int, n_tokens: int):
    """The gather's slots grouped by token, for its transpose: ``(perm,
    tok_off)`` with ``perm [G, E * C]`` each group's slots ``e * C + c``
    sorted stably by the token row they read (dead slots, ``c >= sizes[g,
    e]``, last) and ``tok_off [G, n_tokens + 1]``, token ``t``'s live
    slots at ``perm[g, tok_off[g, t]:tok_off[g, t + 1]]``; both int32. The
    slots and token rows are clamped as :func:`moe_gather_ref` clamps
    them."""
    g, e = offsets.shape
    dev = offsets.device
    n_stream = n_tokens if rows is None else rows.shape[1]
    c = torch.arange(capacity, device=dev)
    slot = (offsets.long()[..., None] + c).clamp(0, max(n_stream - 1, 0))  # [G, E, C]
    tok = slot if rows is None else rows.long().gather(1, slot.reshape(g, -1)).reshape(slot.shape)
    tok = tok.clamp(0, max(n_tokens - 1, 0))
    key = torch.where(c < sizes.long()[..., None], tok, n_tokens).reshape(g, e * capacity)
    _, perm = torch.sort(key, dim=1, stable=True)
    counts = torch.zeros(g, n_tokens + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(1, key, torch.ones_like(key))
    tok_off = torch.zeros(g, n_tokens + 1, dtype=torch.int64, device=dev)
    tok_off[:, 1:] = torch.cumsum(counts[:, :n_tokens], dim=1)
    return perm.to(torch.int32), tok_off.to(torch.int32)


def moe_gather_bwd_ref(dout: torch.Tensor, rows: Optional[torch.Tensor], offsets: torch.Tensor,
                       sizes: torch.Tensor, capacity: int, n_tokens: int) -> torch.Tensor:
    """The transpose of :func:`moe_gather_ref`: ``dx [G, n_tokens, D]`` with
    ``dx[g, t] = sum of dout[g, e, c]`` over the live slots ``(e, c)`` that
    read token row ``t``, added one slot after another in slot order (the
    order of :func:`moe_gather_inverse`) in float32 (float64 for float64),
    in dout's dtype: the kernel's order of summation, so the two agree bit
    for bit."""
    g, e, cap, d = dout.shape
    perm, tok_off = moe_gather_inverse(offsets, sizes, rows, capacity, n_tokens)
    ct = torch.promote_types(dout.dtype, torch.float32)
    flat = dout.reshape(g, e * cap, d).to(ct)
    start, count = tok_off[:, :-1].long(), (tok_off[:, 1:] - tok_off[:, :-1]).long()
    acc = torch.zeros(g, n_tokens, d, dtype=ct, device=dout.device)
    for r in range(int(count.max()) if count.numel() else 0):
        has = count > r  # [G, T]
        slot = perm.long().gather(1, torch.where(has, start + r, 0))
        rows_r = flat.gather(1, slot[..., None].expand(g, n_tokens, d))
        acc = torch.where(has[..., None], acc + rows_r, acc)
    return acc.to(dout.dtype)
