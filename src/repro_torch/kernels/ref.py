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
from typing import Optional, Tuple

import torch

LOG2E = 1.4426950408889634  # the kernels' log2(e): exp(x) = exp2(x * LOG2E)
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


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, causal: bool = True, window: int = 0,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Each query row's log-sum-exp as the tensor-core forward writes it
    for the backward (``csrc/flash_attention_sm90.cu`` with ``lse``):
    float32 ``[B, H, Lq]`` in the log2 domain of the scaled scores, ``m +
    log2(sum(exp2(x - m)))`` over the keys the row sees, where ``x = scale *
    log2(e) * q.k``; ``+inf`` for a row that sees no key (its P is then 0).
    ``lse * ln(2)`` is the natural log-sum-exp of ``scale * q.k``."""
    h, hkv = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[3]) if scale is None else scale
    kr = k.repeat_interleave(h // hkv, dim=1) if hkv != h else k
    x = _masked_logits(q.float(), kr.float(), causal, window) * (scale * LOG2E)
    m = x.amax(dim=-1)
    live = torch.isfinite(m)
    m0 = torch.where(live, m, torch.zeros_like(m))
    lse = m0 + torch.log2(torch.exp2(x - m0[..., None]).sum(dim=-1))
    return torch.where(live, lse, torch.full_like(lse, float("inf")))


def flash_attention_bwd_sm90_ref(q, k, v, out, dout, lse, causal: bool = True, window: int = 0,
                                 scale: Optional[float] = None,
                                 drop_keys: Optional[Tuple[int, int]] = None):
    """``(dq, dk, dv)`` as ``csrc/flash_attention_bwd_sm90.cu`` computes
    them, for the tests and chip_smoke.py: the formula of
    :func:`flash_attention_bwd_ref` with the kernels' numerics. P comes
    from the forward's ``lse`` (:func:`attention_lse_ref`), ``exp2(scale *
    log2(e) * q.k - lse)`` where visible; ``delta = rowsum(dO o O)``; P is
    rounded to bf16 before ``dV = P^T dO`` and ``dS = P o (dP - delta)``
    (from the float32 P) before ``dQ = scale dS K`` and ``dK = scale dS^T
    Q``; every product of bf16 values summed in float32. Each gradient in
    its input's dtype and shape. ``drop_keys = (lo, hi)`` zeroes P at keys
    ``[lo, hi)`` (a key tile skipped): the fault a control must catch."""
    h, hkv = q.shape[1], k.shape[1]
    group = h // hkv
    scale = 1.0 / math.sqrt(q.shape[3]) if scale is None else scale
    kr, vr = (t.float().repeat_interleave(group, dim=1) for t in (k, v))
    x = _masked_logits(q.float(), kr, causal, window) * (scale * LOG2E)
    p = torch.exp2(x - lse.float()[..., None])
    if drop_keys is not None:
        p[..., drop_keys[0]:drop_keys[1]] = 0.0
    g = dout.float()
    dp = torch.einsum("bhqd,bhkd->bhqk", g, vr)
    ds = p * (dp - (g * out.float()).sum(dim=-1, keepdim=True))
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds16, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds16, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p16, g)
    dk = dk.unflatten(1, (hkv, group)).sum(dim=2)
    dv = dv.unflatten(1, (hkv, group)).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_simt_ref(q, k, v, out, dout, lse, causal: bool = True, window: int = 0,
                                 scale: Optional[float] = None, *, keys: int = 64,
                                 rows: int = 64, fault: Optional[str] = None):
    """``(dq, dk, dv)`` as ``csrc/flash_attention_bwd.cu`` computes them in
    float32, taken in its steps, for the tests and chip_smoke.py. P comes
    from the forward's ``lse`` (log2 domain, :func:`attention_lse_ref`),
    ``exp2(scale * log2(e) * q.k - lse)`` where visible, else 0; ``delta =
    rowsum(dO o O)``, ``dS = P o (dP - delta)``. Each block of ``keys``
    keys of a kv head walks the query tiles of ``rows`` rows that see any of
    its keys, the group's heads in order and each head's tiles in order,
    summing ``P^T dO`` into dV and ``dS^T Q`` into dK (scaled once at the
    end), and writes its part ``dS K`` of each tile's dQ; dQ of a row is
    ``scale`` times the parts of the key tiles its query tile meets, summed
    in key-tile order (:func:`.flash_attention.bwd_tiles` gives both
    sizes). Each gradient in its input's dtype and shape.
    ``fault="lse_row"``: each row reads the next row's lse (a row statistic
    copied one row off), the fault the tests' control must catch."""
    b, h, lq, dqk = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    group = h // hkv
    scale = 1.0 / math.sqrt(dqk) if scale is None else scale
    off = lk - lq
    qf, kf, vf, gf = (t.float() for t in (q, k, v, dout))
    lse = lse.float()
    if fault == "lse_row":
        lse = torch.cat([lse[..., 1:], lse[..., -1:]], dim=-1)
    elif fault is not None:
        raise ValueError(f"flash_attention_bwd_simt_ref: unknown fault {fault!r}")
    kr, vr = (t.repeat_interleave(group, dim=1) for t in (kf, vf))
    x = _masked_logits(qf, kr, causal, window)
    p = torch.where(torch.isfinite(x), torch.exp2(x * (scale * LOG2E) - lse[..., None]),
                    torch.zeros_like(x))
    delta = (gf * out.float()).sum(dim=-1)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", gf, vr) - delta[..., None])
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for k0 in range(0, lk, keys):  # (b) dK and dV of each key tile
        k1 = min(k0 + keys, lk)
        i_lo = max(0, k0 - off) if causal else 0
        i_hi = min(lq, k1 - 1 + window - off) if window > 0 else lq
        acc_k = torch.zeros(b, hkv, k1 - k0, dqk, device=q.device)
        acc_v = torch.zeros(b, hkv, k1 - k0, vf.shape[-1], device=q.device)
        for gi in range(group if i_lo < i_hi else 0):
            heads = slice(gi, h, group)  # head gi of every kv head's group
            for r0 in range((i_lo // rows) * rows, i_hi, rows):
                rs = slice(r0, min(r0 + rows, lq))
                acc_v += torch.einsum("bhqk,bhqd->bhkd", p[:, heads, rs, k0:k1], gf[:, heads, rs])
                acc_k += torch.einsum("bhqk,bhqd->bhkd", ds[:, heads, rs, k0:k1], qf[:, heads, rs])
        dk[:, :, k0:k1], dv[:, :, k0:k1] = acc_k * scale, acc_v
    dq = torch.zeros_like(qf)
    for r0 in range(0, lq, rows):  # (c) dQ: the key tiles' parts, in order
        r1 = min(r0 + rows, lq)
        lo = max(0, off + r0 - window + 1) if window > 0 else 0
        hi = min(lk, off + r1) if causal else lk
        acc = torch.zeros(b, h, r1 - r0, dqk, device=q.device)
        for k0 in range((lo // keys) * keys, hi if lo < hi else 0, keys):
            ks = slice(k0, min(k0 + keys, lk))
            acc += torch.einsum("bhqk,bhkd->bhqd", ds[:, :, r0:r1, ks], kr[:, :, ks])
        dq[:, :, r0:r1] = acc * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_sm90_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool = True, window: int = 0,
                             scale: Optional[float] = None, *, block_rows: int = 128,
                             keys: int = 64, fault: Optional[str] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core forward's schedule in plain PyTorch, for the CPU
    tests: ``(out, lse)`` as ``csrc/flash_attention_sm90.cu`` computes them,
    taken in its steps. A kv head's ``group x Lq`` query rows are numbered
    head-major (row ``r``: head ``r // Lq`` of the group, position ``r %
    Lq``) and cut into blocks of ``block_rows`` (128: two consumer
    warpgroups; 64: one); each block streams the key tiles of ``keys`` keys
    from the first key any of its rows sees (``k_begin``), and each 64-row
    half (a consumer) folds the tiles its own rows see into its running
    ``(m, l, O)``: the scores of the bf16 values summed in float32, scaled
    into the exp2 domain (``scale * log2(e)``), masked key by key only on
    its first tile and on the tiles not inside every one of its rows' keys,
    the tile's max, ``alpha = exp2(m_old - m_new)``, ``P = exp2(x -
    m_new)`` summed into ``l`` in float32 and rounded to bf16 before ``O =
    alpha O + P V``, one rescale of O a tile. ``out = O / max(l, 1e-30)`` in
    q's dtype; ``lse = m + log2(l)`` (``+inf`` for a row that sees no key),
    float32 ``[B, H, Lq]``. ``fault`` breaks the last consumer of every
    block, for the tests' control: ``"skip_rescale"`` leaves its O
    unrescaled, ``"next_stage"`` multiplies each P by the next tile's V
    (zeros past the last)."""
    b, h, lq, dqk = q.shape
    hkv, lk, dv = k.shape[1], k.shape[2], v.shape[3]
    group = h // hkv
    rows = group * lq
    scale = 1.0 / math.sqrt(dqk) if scale is None else scale
    sl2 = scale * LOG2E
    qf = q.float().reshape(b, hkv, rows, dqk)
    kf, vf = k.float(), v.float()
    out = torch.zeros(b, hkv, rows, dv)
    lse = torch.full((b, hkv, rows), float("inf"))
    pos0 = lk - lq

    def keys_of(r0, r1):  # (lo, hi, max_lo, min_hi) of rows [r0, r1), as the kernel's keys_of
        min_i, max_i = (r0 % lq, (r1 - 1) % lq) if r0 // lq == (r1 - 1) // lq else (0, lq - 1)
        hi = min(lk, pos0 + max_i + 1) if causal else lk
        lo = max(0, pos0 + min_i - window + 1) if window > 0 else 0
        min_hi = min(lk, pos0 + min_i + 1) if causal else lk
        max_lo = max(0, pos0 + max_i - window + 1) if window > 0 else 0
        return lo, hi, max_lo, min_hi

    for r0 in range(0, rows, block_rows):
        k_begin, k_end, _, _ = keys_of(r0, min(r0 + block_rows, rows))
        n_tiles = -(-(k_end - k_begin) // keys) if k_end > k_begin else 0
        halves = range(r0, min(r0 + block_rows, rows), 64)
        for c, rc0 in enumerate(halves):
            rc1 = min(rc0 + 64, rows)
            lo, hi, max_lo, min_hi = keys_of(rc0, rc1)
            if hi <= lo:
                continue
            ta, tb = (lo - k_begin) // keys, -(-(hi - k_begin) // keys)
            e0 = -(-(max_lo - k_begin) // keys) if max_lo > k_begin else 0
            e1 = (min_hi - k_begin) // keys if min_hi > k_begin else 0
            u0 = min(max(e0, ta + 1), tb)
            u1 = min(max(e1, u0), tb)
            broken = fault if c == len(halves) - 1 else None
            p_of_row = torch.arange(rc0, rc1) % lq + pos0
            row_lo = (p_of_row - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(
                p_of_row)
            row_hi = (p_of_row + 1).clamp(max=lk) if causal else torch.full_like(p_of_row, lk)
            qt = qf[:, :, rc0:rc1]
            m = torch.full((b, hkv, rc1 - rc0), float("-inf"))
            l_sum = torch.zeros_like(m)
            acc = torch.zeros(b, hkv, rc1 - rc0, dv)
            for t in range(ta, tb):
                k0 = k_begin + t * keys
                k1 = min(k0 + keys, lk)
                x = torch.einsum("bhqd,bhkd->bhqk", qt, kf[:, :, k0:k1]) * sl2
                if t == ta or not u0 <= t < u1:  # an edge tile: each key checked
                    kp = torch.arange(k0, k1)[None, :]
                    seen = (kp >= row_lo[:, None]) & (kp < row_hi[:, None])
                    x = x.masked_fill(~seen, float("-inf"))
                m_new = torch.maximum(m, x.amax(dim=-1))
                base = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
                alpha = torch.exp2(m - base)
                p = torch.exp2(x - base[..., None])
                l_sum = l_sum * alpha + p.sum(dim=-1)
                if broken != "skip_rescale":
                    acc = acc * alpha[..., None]
                vt = vf[:, :, k0:k1]
                if broken == "next_stage":
                    n0, n1 = k0 + keys, min(k0 + 2 * keys, lk)
                    vt = torch.zeros_like(vt)
                    if t + 1 < n_tiles and n1 > n0:
                        vt[:, :, :n1 - n0] = vf[:, :, n0:n1]
                acc = acc + torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), vt)
                m = m_new
            out[:, :, rc0:rc1] = acc * (1.0 / l_sum.clamp_min(1e-30))[..., None]
            lse[:, :, rc0:rc1] = torch.where(l_sum > 0, m + torch.log2(l_sum),
                                             torch.full_like(m, float("inf")))
    return (out.reshape(b, h, lq, dv).to(q.dtype), lse.reshape(b, h, lq))


def _masked_logits(q, k, causal: bool, window: int) -> torch.Tensor:
    """``q.k`` of ``q [B, H, Lq, D]`` and ``k [B, H, Lk, D]`` (kv heads
    repeated), unscaled, with the pairs a row does not see at -inf
    (query ``i`` at position ``Lk - Lq + i``)."""
    lq, lk = q.shape[2], k.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k)
    q_pos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
    k_pos = torch.arange(lk, device=q.device)[None, :]
    mask = torch.ones(lq, lk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return logits.masked_fill(~mask, float("-inf"))


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
                              rescale: bool = True, broken: Optional[str] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """The decode route's schedule (``csrc/flash_attention.cu``,
    ``flash_decode_kernel``) in plain PyTorch, for the tests: what
    :func:`flash_attention_ref` computes, taken in the kernel's order.
    Split ``s`` holds keys ``[s * chunk, (s + 1) * chunk)`` (cut at
    ``Lk``); in it, team ``t`` of ``teams`` folds keys ``s * chunk + t``,
    ``+ teams``, ... in that order, ``unit`` at a time (round ``u``: keys
    ``s * chunk + u * teams * unit + j * teams + t``, ``j < unit``), into
    its own running ``(m, l, acc)``, rescaled by ``exp(m - m_new)`` where a
    unit raises the max; the teams' states are folded in team order, then
    the splits' in split order, and ``acc`` is divided by ``l`` clamped at
    ``1e-30``. The teams run side by side here, a round a step. Faults, the
    controls of ``chip_smoke.py``: ``rescale=False`` folds the splits
    without their ``exp(m_s - m)`` weights; ``broken="lost_split"`` leaves
    the last split out of the fold (a last block that folds before every
    split has written its partial); ``broken="no_unit_rescale"`` leaves out
    a team's rescale when a unit raises its max."""
    b, h, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    logits = _masked_logits(q.float(), k.float(), causal, window) * scale
    vf = v.float()
    dv = vf.shape[-1]
    neg = float("-inf")
    splits = []
    for s in range(n_splits):
        s0, s1 = s * chunk, min(lk, (s + 1) * chunk)
        rounds = -(-max(s1 - s0, 0) // (teams * unit))
        # key of (round, slot j, team), and whether it lies in the split
        idx = (s0 + torch.arange(rounds * unit, device=q.device)[:, None] * teams
               + torch.arange(teams, device=q.device)[None, :]).reshape(rounds, unit, teams)
        live = idx < s1
        idx = idx.clamp(max=max(lk - 1, 0))
        m = torch.full((b, h, lq, teams), neg, device=q.device)
        l_sum = torch.zeros_like(m)
        acc = torch.zeros(b, h, lq, teams, dv, device=q.device)
        for u in range(rounds):
            sc = logits[..., idx[u]].masked_fill(~live[u], neg)  # [B, H, Lq, unit, teams]
            m_new = torch.maximum(m, sc.amax(dim=-2))
            raised = m_new != m
            alpha = torch.where(raised, torch.exp(m - m_new), torch.ones_like(m))
            if broken == "no_unit_rescale":
                alpha = torch.where(m == neg, alpha, torch.ones_like(m))
            p = torch.where(sc > neg, torch.exp(sc - m_new[..., None, :]), torch.zeros_like(sc))
            l_sum = l_sum * alpha + p.sum(dim=-2)
            vu = vf[:, :, idx[u]] * live[u][..., None]  # [B, H, unit, teams, Dv]
            acc = acc * alpha[..., None] + torch.einsum("bhqjt,bhjtd->bhqtd", p, vu)
            m = m_new
        splits.append(_fold_partials([(m[..., t], l_sum[..., t], acc[..., t, :])
                                      for t in range(teams)]))
    if broken == "lost_split" and len(splits) > 1:
        splits = splits[:-1]
    _, l_sum, acc = _fold_partials(splits, rescale)
    return (acc / l_sum.clamp_min(1e-30)[..., None]).to(q.dtype)


def flash_attention_tile_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool = True, window: int = 0, *, bm: int, bn: int,
                             rescale: bool = True, scale: Optional[float] = None,
                             with_lse: bool = False):
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
    fault control of ``chip_smoke.py``. ``with_lse``: return ``(out,
    lse)``, ``lse`` each row's log-sum-exp as the kernel writes it for the
    backward, ``m + log2(l)`` of the row's running max and sum in the log2
    domain of the scaled scores (the natural ones here times log2(e)),
    ``+inf`` for a row that sees no key, float32 ``[B, H, Lq]``."""
    from .flash_attention import key_tiles  # the wrapper imports this module

    b, h, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    group, rows = h // hkv, h // hkv * lq
    qf = q.float().reshape(b, hkv, group, lq, dh).transpose(2, 3).reshape(b, hkv, rows, dh)
    kf, vf = k.float(), v.float()
    q_pos = torch.arange(rows, device=q.device) // group + (lk - lq)
    dv = v.shape[-1]
    out = torch.zeros(b, hkv, rows, dv, device=q.device)
    lse = torch.full((b, hkv, rows), float("inf"), device=q.device)
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
        lse[:, :, r0:r1] = torch.where(l_sum > 0, m * LOG2E + torch.log2(l_sum), lse[:, :, r0:r1])
    out = out.reshape(b, hkv, lq, group, dv).transpose(2, 3).reshape(b, h, lq, dv).to(q.dtype)
    if not with_lse:
        return out
    return out, lse.reshape(b, hkv, lq, group).transpose(2, 3).reshape(b, h, lq)


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
