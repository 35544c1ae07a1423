"""Plain PyTorch versions of the hand-written kernels.

Each function here defines what its kernel computes. The wrappers in
:mod:`.shuffle_reduce` and :mod:`.edge_stream` run these for tensors that
lie on the CPU; the tests and ``chip_smoke.py`` hold each kernel against
its plain version. They repeat the kernel's arithmetic and are no
yardstick of speed.
"""
from __future__ import annotations

import torch

_OPS = ("+", "min", "max")
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
    raise ValueError(f"no identity for reduce op {op!r}")


def _scatter(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor, op: str):
    if op == "+":
        return out.index_add_(0, idx, vals)
    if op in ("min", "max"):
        return out.scatter_reduce_(0, idx.long(), vals, "a" + op, include_self=True)
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
