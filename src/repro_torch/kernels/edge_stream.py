"""Fused edge pipeline: the hand-written CUDA kernel ``csrc/edge_stream.cu``.

Replaces the reference package's Pallas TPU kernel
``kernels/edge_stream.py::edge_stream_call`` (and its wrapper
``kernels/ops.py::edge_stream``). What bounds it on an H100 is bytes: the
edge-sized streams (source ids, edge ids, weights) are read once; the
vertex-sized operands it gathers fit in L2 at the paper's graph sizes.
Unlike the TPU kernel, which took a pre-gathered source operand, this one
fuses the source gather: the engine hands in the vertex-side operand and
mask once per launch, and the dst-sorted edge lists and their work list
(:func:`.shuffle_reduce.split_bins`: bins longer than ``SPLIT_LEN`` cut
into chunks of their own) once per bind.

Entry points, each with a batched twin over ``K`` rows (queries, or the
32-source words of multi-source BFS) that share the edges, named after
the reference's ``kernels/ops.py``:

* :func:`edge_stream_gather` — the kernel itself, in its fused-gather
  form (what the engine's full-stream edge launches call).
  :func:`edge_stream_gather_batched` takes ``[K, V]`` vertex operands and
  ``[E]`` (shared, as a graph's weights are) or ``[K, E]`` weights over one
  set of sorted edges, offsets and work list: one call, whose warps walk
  the edges once for each group of :func:`row_group` rows (the rows of a
  group packed side by side a vertex first), each row folded as its own
  one-row launch folds it.
* :func:`edge_stream` — the reference's shape ``(src_vals, weights, dst,
  active)`` per edge: a stable sort by ``dst`` is the routing step (and
  the work list is built anew on every call), and the same kernel runs
  with an identity gather (vertex operand = the per-edge stream, indexed
  by the sort permutation). :func:`edge_stream_batched` takes ``[K, E]``
  source values over one ``dst``, with ``weights`` and ``active`` shared or
  per row.

Reduce ``"|"`` (bitwise OR, int32 only) is the multi-source BFS step.

A CPU tensor takes the plain version in :mod:`.ref`; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, ref
from .shuffle_reduce import (DTYPE_CODES, MAX_ROWS, OP_CODES, SPLIT_LEN, BinSplit,
                             bin_offsets, check_op, rows_of, split_bins)

#: calls that launched the CUDA kernels since the last reset (set it to 0 to
#: reset): one per call, also when a batch adds the pack and a split bin the
#: combining kernel
LAUNCHES = 0

APPLY_CODES = {"add": 0, "mul": 1, "src": 2}

#: rows a warp of a batched launch walks together (``csrc/edge_stream.cu``'s R)
GROUP_ROWS = (2, 8, 16)

# vval, vact, n_vertices, src_s, eid_s, n_edges, w, offsets, out, n_out, chunks,
# n_chunks, chunk_len, split_bins, split_first, n_split, partial, n_rows,
# vval_stride, vact_stride, w_stride, group_rows, tile, bits, dtype, apply, op,
# stream
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int64] + [ctypes.c_void_p] * 2
             + [ctypes.c_int64] + [ctypes.c_void_p] * 3
             + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
             + [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_void_p]
             + [ctypes.c_int64] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def row_group(k: int) -> int:
    """Rows a warp walks together in a ``k``-row launch: the least of
    :data:`GROUP_ROWS` that holds them all, else the largest (the last
    group then partial)."""
    return next((r for r in GROUP_ROWS if r >= k), GROUP_ROWS[-1])


def _lib():
    lib = _build.load("edge_stream")
    fn = lib.repro_edge_stream
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def edge_stream_gather(
    vval: torch.Tensor,
    vact: torch.Tensor,
    src_s: torch.Tensor,
    eid_s: Optional[torch.Tensor],
    weights: Optional[torch.Tensor],
    offsets: torch.Tensor,
    apply_op: str,
    reduce_op: str,
    split: Optional[BinSplit] = None,
) -> torch.Tensor:
    """Per dst-sorted edge ``e``: ``s = src_s[e]``, ``upd = vact[s] ?
    apply(vval[s], weights[eid_s[e]]) : identity``; bin ``b`` reduces
    edges ``offsets[b]:offsets[b+1]``. Returns ``[len(offsets) - 1]``.

    ``split`` is the work list :func:`.shuffle_reduce.split_bins` built from
    these ``offsets`` (the engine builds it once per bind); without it a
    CUDA call builds it here. The plain version on the CPU needs none."""
    _check(vval, vact, src_s, eid_s, weights, apply_op, reduce_op)
    if vval.dim() != 1 or vact.shape != vval.shape:
        raise ValueError("edge_stream: vval and vact must be [V]")
    if vval.device.type == "cpu":
        return ref.edge_stream_gather_ref(vval, vact, src_s, eid_s, weights, offsets,
                                          apply_op, reduce_op)
    return _launch(vval[None], vact[None], src_s, eid_s,
                   None if weights is None else weights[None], offsets, apply_op, reduce_op,
                   split)[0]


def edge_stream_gather_batched(
    vval: torch.Tensor,
    vact: torch.Tensor,
    src_s: torch.Tensor,
    eid_s: Optional[torch.Tensor],
    weights: Optional[torch.Tensor],
    offsets: torch.Tensor,
    apply_op: str,
    reduce_op: str,
    split: Optional[BinSplit] = None,
) -> torch.Tensor:
    """:func:`edge_stream_gather` of every row of ``[K, V]`` vertex values:
    ``[K, len(offsets) - 1]`` in one call. ``vact`` is ``[V]`` (shared by
    the rows) or ``[K, V]``; ``weights`` ``[E]`` (shared) or ``[K, E]``.
    Rows must each be contiguous; a row stride of 0 (an expanded row)
    shares one row. Row ``k`` has the bits of ``edge_stream_gather(vval[k],
    ...)``: each row folds each bin in the one-row order."""
    _check(vval, vact, src_s, eid_s, weights, apply_op, reduce_op)
    if vval.dim() != 2 or vact.shape[-1] != vval.shape[1] or vact.dim() not in (1, 2):
        raise ValueError(f"edge_stream: vval must be [K, V] and vact [V] or [K, V], got "
                         f"{tuple(vval.shape)} and {tuple(vact.shape)}")
    if vval.device.type == "cpu":
        return ref.edge_stream_gather_batched_ref(vval, vact, src_s, eid_s, weights, offsets,
                                                  apply_op, reduce_op)
    k = vval.shape[0]
    vact = vact.expand(k, -1) if vact.dim() == 1 else vact
    if weights is not None and weights.dim() == 1:
        weights = weights.expand(k, -1)
    return _launch(vval, vact, src_s, eid_s, weights, offsets, apply_op, reduce_op, split)


def _check(vval, vact, src_s, eid_s, weights, apply_op: str, reduce_op: str) -> None:
    if apply_op not in APPLY_CODES:
        raise ValueError(f"edge_stream: unsupported apply {apply_op!r}")
    check_op(reduce_op, vval.dtype, "edge_stream")
    if apply_op != "src":
        if eid_s is None or weights is None:
            raise ValueError(f"edge_stream: apply {apply_op!r} needs eid_s and weights")
        if eid_s.shape != src_s.shape:
            raise ValueError("edge_stream: eid_s must be shaped like src_s")


def _launch(vval, vact, src_s, eid_s, weights, offsets, apply_op: str, reduce_op: str,
            split: Optional[BinSplit]) -> torch.Tensor:
    """One call of the kernels over the ``K`` rows of ``vval``, ``vact``
    and ``weights`` (each ``[K, n]``, any row stride): the one-row walk for
    ``K = 1``, else the pack and the walk of the row groups."""
    global LAUNCHES
    weighted = apply_op != "src"
    k = vval.shape[0]
    n_out = offsets.shape[0] - 1
    tensors = [vval, vact, src_s, offsets] + ([eid_s, weights] if weighted else [])
    if vval.device.type != "cuda" or any(t.device != vval.device for t in tensors):
        raise ValueError("edge_stream: every tensor must be on one CUDA device")
    if vval.dtype not in DTYPE_CODES:
        raise TypeError(f"edge_stream: unsupported dtype {vval.dtype}")
    if weighted and weights.dtype != vval.dtype:
        raise TypeError("edge_stream: weights must have the vertex operand's dtype")
    if vact.dtype != torch.bool or vact.shape != vval.shape:
        raise TypeError("edge_stream: vact must be a bool mask shaped like vval")
    if weighted and weights.shape[0] != k:
        raise ValueError("edge_stream: weights must have vval's rows")
    if any(t.dtype != torch.int32 for t in (src_s, offsets, *([eid_s] if weighted else []))):
        raise TypeError("edge_stream: src_s, eid_s and offsets must be int32")
    if not 1 <= k <= MAX_ROWS:
        raise ValueError(f"edge_stream: {k} rows, the kernel takes 1 to {MAX_ROWS}")
    if split is None:
        split = split_bins(offsets, src_s.shape[0])
    lists = (split.chunks, split.bins, split.first)
    if any(t.device != vval.device or t.dtype != torch.int32 for t in lists):
        raise TypeError("edge_stream: the work list must be int32 on the operands' device")
    (vval, vval_stride), (vact, vact_stride) = rows_of(vval), rows_of(vact)
    n_v = vval.shape[1]
    src_s, offsets = src_s.contiguous(), offsets.contiguous()
    chunks, bins, first = (t.contiguous() for t in lists)
    n_chunks = chunks.shape[0]
    eid_p = w_p = None
    w_stride = 0
    if weighted:
        eid_s = eid_s.contiguous()
        weights, w_stride = rows_of(weights)
        eid_p, w_p = eid_s.data_ptr(), weights.data_ptr()
    out = torch.empty(k, n_out, dtype=vval.dtype, device=vval.device)
    if n_out == 0:
        return out
    partial = torch.empty(k, n_chunks, dtype=vval.dtype, device=vval.device)
    # a batch's scratch: each group's rows packed as a [V, R] tile and, for
    # weighted applies, its rows' flags as one R-bit word a vertex
    group = row_group(k)
    n_groups = -(-k // group)
    tile = bits = None
    if k > 1:
        tile = torch.empty(n_groups, n_v, group, dtype=vval.dtype, device=vval.device)
        if weighted:
            bits = torch.empty(n_groups, n_v, -(-group // 8), dtype=torch.uint8,
                               device=vval.device)
    rc = _lib()(vval.data_ptr(), vact.data_ptr(), n_v, src_s.data_ptr(), eid_p,
                src_s.shape[0], w_p, offsets.data_ptr(), out.data_ptr(), n_out,
                chunks.data_ptr(), n_chunks, SPLIT_LEN, bins.data_ptr(), first.data_ptr(),
                bins.shape[0], partial.data_ptr(), k, vval_stride, vact_stride, w_stride,
                group, None if tile is None else tile.data_ptr(),
                None if bits is None else bits.data_ptr(), DTYPE_CODES[vval.dtype],
                APPLY_CODES[apply_op],
                OP_CODES[reduce_op], torch.cuda.current_stream(vval.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"edge_stream kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def edge_stream(
    src_vals: torch.Tensor,
    weights: torch.Tensor,
    dst: torch.Tensor,
    active: torch.Tensor,
    n_out: int,
    apply_op: str = "add",
    reduce_op: str = "min",
) -> torch.Tensor:
    """Fused gather->apply->shuffle->reduce over per-edge operands (the
    reference's ``ops.edge_stream``); destinations outside ``[0, n_out)``
    are dropped. Matches :func:`.ref.edge_stream_ref`."""
    if src_vals.device.type == "cpu":
        return ref.edge_stream_ref(src_vals, weights, dst, active, n_out,
                                   apply_op, reduce_op)
    dst_s, perm = torch.sort(dst, stable=True)
    perm = perm.to(torch.int32)
    return edge_stream_gather(src_vals, active, perm, perm, weights,
                              bin_offsets(dst_s, n_out), apply_op, reduce_op)


def edge_stream_batched(
    src_vals: torch.Tensor,
    weights: torch.Tensor,
    dst: torch.Tensor,
    active: torch.Tensor,
    n_out: int,
    apply_op: str = "add",
    reduce_op: str = "min",
) -> torch.Tensor:
    """:func:`edge_stream` of each row of ``[K, E]`` source values over one
    ``dst`` ``[E]``: ``[K, n_out]`` (the reference's
    ``ops.edge_stream_batched``, with the destinations shared). ``weights``
    and ``active`` are ``[E]`` (shared by the rows) or ``[K, E]``. ``dst`` is
    routed once and the rows go through one batched launch."""
    if src_vals.dim() != 2 or dst.dim() != 1:
        raise ValueError(f"edge_stream_batched: src_vals must be [K, E] and dst [E], got "
                         f"{tuple(src_vals.shape)} and {tuple(dst.shape)}")
    if src_vals.device.type == "cpu":
        check_op(reduce_op, src_vals.dtype, "edge_stream")
        return ref.edge_stream_batched_ref(src_vals, weights, dst, active, n_out, apply_op,
                                           reduce_op)
    dst_s, perm = torch.sort(dst, stable=True)
    perm = perm.to(torch.int32)
    return edge_stream_gather_batched(src_vals, active, perm, perm, weights,
                                      bin_offsets(dst_s, n_out), apply_op, reduce_op)
