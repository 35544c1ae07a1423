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

Two entry points:

* :func:`edge_stream_gather` — the kernel itself, in its fused-gather
  form (what the engine's full-stream edge launches call).
* :func:`edge_stream` — the reference's shape ``(src_vals, weights, dst,
  active)`` per edge: a stable sort by ``dst`` is the routing step (and
  the work list is built anew on every call), and the same kernel runs
  with an identity gather (vertex operand = the per-edge stream, indexed
  by the sort permutation).

A CPU tensor takes the plain version in :mod:`.ref`; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, ref
from .shuffle_reduce import (DTYPE_CODES, OP_CODES, SPLIT_LEN, BinSplit, bin_offsets,
                             split_bins)

#: calls that launched the CUDA kernels since the last reset (set it to 0 to
#: reset): one per call, also when a split bin adds the combining kernel
LAUNCHES = 0

APPLY_CODES = {"add": 0, "mul": 1, "src": 2}

# vval, vact, src_s, eid_s, n_edges, w, offsets, out, n_out, chunks, n_chunks,
# chunk_len, split_bins, split_first, n_split, partial, dtype, apply, op, stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_void_p] * 3
             + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
             + [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_void_p]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


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
    global LAUNCHES
    if apply_op not in APPLY_CODES:
        raise ValueError(f"edge_stream: unsupported apply {apply_op!r}")
    if reduce_op not in OP_CODES:
        raise ValueError(f"edge_stream: unsupported reduce {reduce_op!r}")
    weighted = apply_op != "src"
    if weighted and (eid_s is None or weights is None):
        raise ValueError(f"edge_stream: apply {apply_op!r} needs eid_s and weights")
    if weighted and eid_s.shape != src_s.shape:
        raise ValueError("edge_stream: eid_s must be shaped like src_s")
    n_out = offsets.shape[0] - 1
    if vval.device.type == "cpu":
        return ref.edge_stream_gather_ref(vval, vact, src_s, eid_s, weights, offsets,
                                          apply_op, reduce_op)
    tensors = [vval, vact, src_s, offsets] + ([eid_s, weights] if weighted else [])
    if vval.device.type != "cuda" or any(t.device != vval.device for t in tensors):
        raise ValueError("edge_stream: every tensor must be on one CUDA device")
    if vval.dtype not in DTYPE_CODES:
        raise TypeError(f"edge_stream: unsupported dtype {vval.dtype}")
    if weighted and weights.dtype != vval.dtype:
        raise TypeError("edge_stream: weights must have the vertex operand's dtype")
    if vact.dtype != torch.bool or vact.shape != vval.shape:
        raise TypeError("edge_stream: vact must be a bool mask shaped like vval")
    if any(t.dtype != torch.int32 for t in (src_s, offsets, *([eid_s] if weighted else []))):
        raise TypeError("edge_stream: src_s, eid_s and offsets must be int32")
    if split is None:
        split = split_bins(offsets, src_s.shape[0])
    lists = (split.chunks, split.bins, split.first)
    if any(t.device != vval.device or t.dtype != torch.int32 for t in lists):
        raise TypeError("edge_stream: the work list must be int32 on the operands' device")
    vval, vact, src_s, offsets = (t.contiguous() for t in (vval, vact, src_s, offsets))
    chunks, bins, first = (t.contiguous() for t in lists)
    n_chunks = chunks.shape[0]
    eid_p = w_p = None
    if weighted:
        eid_s, weights = eid_s.contiguous(), weights.contiguous()
        eid_p, w_p = eid_s.data_ptr(), weights.data_ptr()
    out = torch.empty(n_out, dtype=vval.dtype, device=vval.device)
    if n_out == 0:
        return out
    partial = torch.empty(n_chunks, dtype=vval.dtype, device=vval.device)
    rc = _lib()(vval.data_ptr(), vact.data_ptr(), src_s.data_ptr(), eid_p, src_s.shape[0],
                w_p, offsets.data_ptr(), out.data_ptr(), n_out, chunks.data_ptr(), n_chunks,
                SPLIT_LEN, bins.data_ptr(), first.data_ptr(), bins.shape[0],
                partial.data_ptr(), DTYPE_CODES[vval.dtype], APPLY_CODES[apply_op],
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
