"""Shuffle+Reduce: the hand-written CUDA kernel ``csrc/shuffle_reduce.cu``.

Replaces the reference package's Pallas TPU kernel
``kernels/shuffle_reduce.py::shuffle_reduce_sorted`` (and its wrapper
``kernels/ops.py::shuffle_reduce``). What bounds it on an H100 is bytes:
one read of each update and one write of each bin. The design (one warp
per bin over a bin-sorted stream, a shuffle tree, no atomics, so float
sums are the same bits on every run) is described in the CUDA source.

Two entry points:

* :func:`shuffle_reduce_sorted` — the kernel itself: a stream already
  sorted by bin plus ``offsets[n_out + 1]``. The engine's full-stream
  commits call it with offsets computed once per bind.
* :func:`shuffle_reduce` — unsorted ``(vals, idx)``: a stable sort plus
  ``searchsorted`` is the routing step (the reference wrapper sorts
  outside its kernel too), then the kernel. Indices outside
  ``[0, n_out)`` are dropped.

A CPU tensor takes the plain version in :mod:`.ref`; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build, ref

#: launches of the CUDA kernel since the last reset (set it to 0 to reset)
LAUNCHES = 0

DTYPE_CODES = {torch.float32: 0, torch.int32: 1}
OP_CODES = {"+": 0, "min": 1, "max": 2}

# vals, n_vals, offsets, out, n_out, dtype, op, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = _build.load("shuffle_reduce")
    fn = lib.repro_shuffle_reduce
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def bin_offsets(sorted_idx: torch.Tensor, n_out: int) -> torch.Tensor:
    """``offsets[b]`` = first position of bin ``b`` in an ascending index
    stream, for ``b`` in ``[0, n_out]`` (int32)."""
    bins = torch.arange(n_out + 1, dtype=sorted_idx.dtype, device=sorted_idx.device)
    return torch.searchsorted(sorted_idx, bins, out_int32=True)


#: the most updates of one bin that one warp walks: 32 steps of 32 lanes
SPLIT_LEN = 1024


class BinSplit(NamedTuple):
    """The work list of a bin-sorted stream: every bin longer than
    :data:`SPLIT_LEN` cut into ``ceil(n_b / SPLIT_LEN)`` chunks.

    Chunk ``k`` covers updates ``[lo + c * SPLIT_LEN, min(hi, lo + (c + 1)
    * SPLIT_LEN))`` of its bin ``[lo, hi)`` and leaves its partial result in
    slot ``k`` of a scratch buffer; split bin ``j`` owns slots
    ``first[j]:first[j+1]``, its chunks in order, which a second pass folds
    into ``out[bins[j]]``. A kernel walks the chunks as work items of their
    own and skips the split bins where it walks the bins.
    """

    chunks: torch.Tensor  # int32 [n_chunks, 2]: (bin, chunk number c)
    bins: torch.Tensor  # int32 [n_split]: the split bins, ascending
    first: torch.Tensor  # int32 [n_split + 1]: first chunk slot of each split bin


def split_bins(offsets: torch.Tensor, n_stream: int) -> BinSplit:
    """The :class:`BinSplit` of ``offsets[n_out + 1]`` over a stream of
    ``n_stream`` updates, with the offsets clamped into ``[0, n_stream]`` as
    the kernels clamp them. Built on the offsets' device; it reads two
    sizes back to the host, so it belongs where the offsets are built (once
    per bind)."""
    off = offsets.clamp(0, n_stream)
    n = (off[1:] - off[:-1]).clamp(min=0)
    bins = torch.nonzero(n > SPLIT_LEN).flatten()
    k = (n[bins] + SPLIT_LEN - 1) // SPLIT_LEN
    first = torch.zeros(bins.shape[0] + 1, dtype=torch.int32, device=offsets.device)
    torch.cumsum(k, 0, out=first[1:])
    n_chunks = int(first[-1])
    chunk_bin = torch.repeat_interleave(bins, k, output_size=n_chunks)
    base = torch.repeat_interleave(first[:-1], k, output_size=n_chunks)
    c = torch.arange(n_chunks, dtype=torch.int32, device=offsets.device) - base
    return BinSplit(torch.stack([chunk_bin.to(torch.int32), c], dim=1), bins.to(torch.int32),
                    first)


def shuffle_reduce_sorted(vals: torch.Tensor, offsets: torch.Tensor, n_out: int,
                          op: str) -> torch.Tensor:
    """Reduce bin ``b`` = ``vals[offsets[b]:offsets[b+1]]`` for every
    ``b < n_out``; empty bins hold the identity of ``op``. ``offsets`` is
    non-decreasing; the kernel clamps it into ``[0, len(vals)]``."""
    global LAUNCHES
    if op not in OP_CODES:
        raise ValueError(f"shuffle_reduce: unsupported op {op!r}")
    if vals.dim() != 1:
        raise ValueError(f"shuffle_reduce: vals must be 1-d, got {tuple(vals.shape)}")
    if offsets.shape != (n_out + 1,):
        raise ValueError(f"offsets must be [n_out + 1] = [{n_out + 1}], "
                         f"got {tuple(offsets.shape)}")
    if vals.device.type == "cpu":
        return ref.segment_reduce_ref(vals, offsets, op)
    if vals.device.type != "cuda" or offsets.device != vals.device:
        raise ValueError("shuffle_reduce: vals and offsets must be on one CUDA device")
    if vals.dtype not in DTYPE_CODES:
        raise TypeError(f"shuffle_reduce: unsupported dtype {vals.dtype}")
    if offsets.dtype != torch.int32:
        raise TypeError("shuffle_reduce: offsets must be int32")
    vals = vals.contiguous()
    offsets = offsets.contiguous()
    out = torch.empty(n_out, dtype=vals.dtype, device=vals.device)
    if n_out == 0:
        return out
    rc = _lib()(vals.data_ptr(), vals.shape[0], offsets.data_ptr(), out.data_ptr(), n_out,
                DTYPE_CODES[vals.dtype], OP_CODES[op],
                torch.cuda.current_stream(vals.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"shuffle_reduce kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out


def route(idx: torch.Tensor, n_out: int):
    """The routing step for an unsorted index stream: ``(perm, offsets)``
    with ``idx[perm]`` ascending (stable) and bin offsets into it, or
    ``(None, offsets)`` when every lane targets one bin (a broadcast
    index, stride 0), which needs no sort."""
    n = idx.shape[0]
    if idx.dim() == 1 and n > 0 and idx.stride(0) == 0:
        bins = torch.arange(n_out + 1, dtype=idx.dtype, device=idx.device)
        offsets = torch.where(bins > idx[0], n, 0).to(torch.int32)
        return None, offsets
    idx_s, perm = torch.sort(idx, stable=True)
    return perm, bin_offsets(idx_s, n_out)


def shuffle_reduce(vals: torch.Tensor, idx: torch.Tensor, n_out: int,
                   op: str = "+") -> torch.Tensor:
    """Scatter-reduce unsorted ``(idx, vals)`` updates into ``n_out`` bins;
    indices outside ``[0, n_out)`` are dropped, empty bins hold the
    identity. Matches :func:`.ref.shuffle_reduce_ref`."""
    if vals.device.type == "cpu":
        return ref.shuffle_reduce_ref(vals, idx, n_out, op)
    perm, offsets = route(idx, n_out)
    vals_s = vals if perm is None else vals[perm]
    return shuffle_reduce_sorted(vals_s, offsets, n_out, op)
