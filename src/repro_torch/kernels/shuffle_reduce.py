"""Shuffle+Reduce: the hand-written CUDA kernel ``csrc/shuffle_reduce.cu``.

Replaces the reference package's Pallas TPU kernel
``kernels/shuffle_reduce.py::shuffle_reduce_sorted`` (and its wrapper
``kernels/ops.py::shuffle_reduce``). What bounds it on an H100 is bytes:
one read of each update and one write of each bin. The kernel walks a work
list (:class:`BinSplit`: every bin longer than :data:`SPLIT_LEN` in
chunks, folded in chunk order) and the rest of the bins in groups of 32,
short bins a lane each; there are no atomics, so float sums are the same
bits on every run. The CUDA source describes the design.

Entry points, each with a batched twin over ``K`` rows (queries) that
share one bin layout, named after the reference's ``kernels/ops.py``:

* :func:`shuffle_reduce_sorted` — the kernel itself: a stream already
  sorted by bin plus ``offsets[n_out + 1]``. The engine's full-stream
  commits call it with the offsets and the work list its bind built.
  :func:`shuffle_reduce_sorted_batched` takes ``[K, N]`` values (a row
  stride of 0 shares one row) over the same offsets and list: one launch,
  the rows on the grid, each row folded as its own one-row launch folds
  it.
* :func:`shuffle_reduce` — unsorted ``(vals, idx)``: a stable sort plus
  ``searchsorted`` is the routing step (the reference wrapper sorts
  outside its kernel too), then the kernel. Indices outside
  ``[0, n_out)`` are dropped. :func:`shuffle_reduce_batched` takes ``[K,
  N]`` values: an index shared by the rows is routed once; an index that
  differs per row is routed per row, bin ``b`` of row ``k`` at ``k * n_out
  + b`` of one stream.

Every route hands the kernel a work list without reading anything back to
the host: a bind's full stream its :func:`split_bins` list, a broadcast
(stride-0) index the list :func:`one_bin_split` sizes on the host, and
any other stream the fixed-shape list of :func:`launch_split`, built on
the device. A CPU tensor takes the plain version in :mod:`.ref`; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build, ref

#: calls that launched the CUDA kernels since the last reset (set it to 0 to
#: reset): one per call, whatever number of kernels the call runs
LAUNCHES = 0

DTYPE_CODES = {torch.float32: 0, torch.int32: 1}
OP_CODES = {"+": 0, "min": 1, "max": 2, "|": 3}  # "|": bitwise OR, int32 only
MAX_ROWS = 65535  # rows of one batched launch (the grid's y dimension)

# vals, n_rows, vals_row_stride, n_vals, offsets, out, n_out, chunks, n_chunks,
# split_bins, split_first, n_split, split_len, partial, dtype, op, stream
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# offsets, n_out, n_vals, split_len, chunks, split_bins, split_first, n_windows, stream
_LIST_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                  ctypes.c_void_p]


def _lib(name: str = "repro_shuffle_reduce", argtypes=_ARGTYPES):
    fn = getattr(_build.load("shuffle_reduce"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
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

    Chunk slot ``k`` holds ``(bin, c)``: it covers updates ``[lo + c *
    SPLIT_LEN, min(hi, lo + (c + 1) * SPLIT_LEN))`` of its bin ``[lo, hi)``
    and leaves its partial result in slot ``k`` of a scratch buffer. Split
    bin ``j`` is ``bins[j]``, and its chunk ``c`` sits in slot ``first[j] +
    c``; a second pass folds its partials in chunk order into
    ``out[bins[j]]``. A kernel walks the chunks as work items of their own
    and skips the split bins where it walks the bins. A fixed-shape list
    (:func:`launch_split`) marks its unused chunk and bin slots with bin
    ``-1``; :func:`split_bins` leaves none, so there split bin ``j`` owns
    slots ``first[j]:first[j+1]``.
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


def split_windows(n_stream: int) -> int:
    """Windows of :data:`SPLIT_LEN` positions in a stream of ``n_stream``
    updates that :func:`launch_split` sizes its list by: 0 when no bin can
    be longer than ``SPLIT_LEN``."""
    return -(-n_stream // SPLIT_LEN) if n_stream > SPLIT_LEN else 0


def launch_split(offsets: torch.Tensor, n_stream: int) -> BinSplit:
    """A :class:`BinSplit` of fixed shapes for a stream of ``n_stream``
    updates over ``offsets[n_out + 1]`` (non-decreasing, clamped into ``[0,
    n_stream]``), built on the offsets' device without reading anything
    back: ``chunks [2W, 2]``, ``bins [W]``, ``first [W + 1]`` for ``W =``
    :func:`split_windows` ``(n_stream)``.

    Window ``v`` covers positions ``[v * SPLIT_LEN, (v + 1) * SPLIT_LEN)``.
    A long bin whose start lies in window ``w`` holds split slot ``w``
    (``first[w] = 2w``) and its chunk ``c`` sits in chunk slot ``2w + c``:
    at most one long bin starts in a window, and the slots of two long bins
    never meet. Unused slots hold ``-1``. Its used chunk and bin slots, in
    slot order, are :func:`split_bins`' list. On a CUDA tensor a kernel
    (``csrc/shuffle_reduce.cu``, ``shuffle_reduce_list_kernel``) writes it;
    on the CPU, :func:`split_bins`' list is scattered into the same
    slots."""
    w = split_windows(n_stream)
    dev = offsets.device
    if dev.type == "cpu":
        return _launch_split_plain(offsets, n_stream, w)
    if dev.type != "cuda" or offsets.dtype != torch.int32 or offsets.dim() != 1:
        raise ValueError("launch_split: offsets must be 1-d int32 on a CUDA device")
    offsets = offsets.contiguous()
    unused = torch.full((5 * w,), -1, dtype=torch.int32, device=dev)
    chunks, bins = unused[:4 * w].view(2 * w, 2), unused[4 * w:]
    first = torch.empty(w + 1, dtype=torch.int32, device=dev)
    if w == 0:
        return BinSplit(chunks, bins, first.zero_())
    rc = _lib("repro_shuffle_reduce_split_list", _LIST_ARGTYPES)(
        offsets.data_ptr(), offsets.shape[0] - 1, n_stream, SPLIT_LEN, chunks.data_ptr(),
        bins.data_ptr(), first.data_ptr(), w, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"shuffle_reduce split list launch failed: CUDA error {rc}")
    return BinSplit(chunks, bins, first)


def _launch_split_plain(offsets: torch.Tensor, n_stream: int, w: int) -> BinSplit:
    """:func:`launch_split`'s list in plain PyTorch: :func:`split_bins`'
    chunks and bins scattered into their window slots."""
    split = split_bins(offsets, n_stream)
    win = offsets.clamp(0, n_stream)[split.bins.long()].long() // SPLIT_LEN
    per_bin = split.first.diff().long()
    slot = 2 * win.repeat_interleave(per_bin) + split.chunks[:, 1].long()
    chunks = torch.full((2 * w, 2), -1, dtype=torch.int32)
    bins = torch.full((w,), -1, dtype=torch.int32)
    chunks[slot] = split.chunks
    bins[win] = split.bins
    return BinSplit(chunks, bins, 2 * torch.arange(w + 1, dtype=torch.int32))


def one_bin_split(idx: torch.Tensor, n_stream: int) -> Optional[BinSplit]:
    """The work list of a stream whose every update targets ``idx[0]`` (a
    broadcast, stride-0 index): one bin of ``n_stream`` updates in
    ``ceil(n_stream / SPLIT_LEN)`` chunks, sized on the host, with the bin
    read on the device. None when the bin is not longer than ``SPLIT_LEN``.
    An ``idx[0]`` outside the bins names a bin the kernel skips."""
    k = -(-n_stream // SPLIT_LEN)
    if k < 2:
        return None
    dev = idx.device
    b = idx[:1].to(torch.int32)
    chunks = torch.stack([b.expand(k), torch.arange(k, dtype=torch.int32, device=dev)], dim=1)
    return BinSplit(chunks, b, torch.arange(0, 2 * k, k, dtype=torch.int32, device=dev))


def check_op(op: str, dtype: torch.dtype, kernel: str) -> None:
    """Raise on a reduce op the kernels do not take for ``dtype``."""
    if op not in OP_CODES:
        raise ValueError(f"{kernel}: unsupported op {op!r}")
    if op == "|" and dtype != torch.int32:
        raise TypeError(f"{kernel}: the bitwise-OR reduce takes int32, not {dtype}")


def rows_of(t: torch.Tensor):
    """``[K, n]`` operand ``t`` with each row contiguous (copied only where
    a row is not) and its row stride: 0 for one row expanded over all ``K``
    (nothing copied), as a kernel that takes a batch of rows reads it."""
    if t.dim() != 2:
        raise ValueError(f"expected a [K, n] operand, got shape {tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        t = t.contiguous()
    return t, (t.stride(0) if t.shape[0] > 1 else t.shape[1])


def shuffle_reduce_sorted(vals: torch.Tensor, offsets: torch.Tensor, n_out: int,
                          op: str, split: Optional[BinSplit] = None) -> torch.Tensor:
    """Reduce bin ``b`` = ``vals[offsets[b]:offsets[b+1]]`` for every
    ``b < n_out``; empty bins hold the identity of ``op``. ``offsets`` is
    non-decreasing; the kernel clamps it into ``[0, len(vals)]``.

    ``split`` is a work list over these offsets and this stream
    (:func:`split_bins`, :func:`one_bin_split`); without one a CUDA call
    builds :func:`launch_split`'s on the device. The plain version on the
    CPU needs none."""
    check_op(op, vals.dtype, "shuffle_reduce")
    if vals.dim() != 1:
        raise ValueError(f"shuffle_reduce: vals must be 1-d, got {tuple(vals.shape)}")
    if vals.device.type == "cpu":
        _check_offsets(offsets, n_out)
        return ref.segment_reduce_ref(vals, offsets, op)
    return _launch(vals.contiguous()[None], offsets, n_out, op, split)[0]


def shuffle_reduce_sorted_batched(vals: torch.Tensor, offsets: torch.Tensor, n_out: int,
                                  op: str, split: Optional[BinSplit] = None) -> torch.Tensor:
    """:func:`shuffle_reduce_sorted` of every row of ``[K, N]`` values over
    one ``offsets`` and work list: ``[K, n_out]`` in one launch. Rows must
    each be contiguous; a row stride of 0 (an expanded row) shares one row
    of values. Row ``k`` has the bits of ``shuffle_reduce_sorted(vals[k],
    ...)``: each row folds each bin in the one-row order."""
    check_op(op, vals.dtype, "shuffle_reduce")
    if vals.dim() != 2:
        raise ValueError(f"shuffle_reduce: vals must be [K, N], got {tuple(vals.shape)}")
    if vals.device.type == "cpu":
        _check_offsets(offsets, n_out)
        return ref.segment_reduce_batched_ref(vals, offsets, op)
    return _launch(vals, offsets, n_out, op, split)


def _check_offsets(offsets: torch.Tensor, n_out: int) -> None:
    if offsets.shape != (n_out + 1,):
        raise ValueError(f"offsets must be [n_out + 1] = [{n_out + 1}], "
                         f"got {tuple(offsets.shape)}")


def _launch(vals: torch.Tensor, offsets: torch.Tensor, n_out: int, op: str,
            split: Optional[BinSplit]) -> torch.Tensor:
    """One launch of the kernel over the ``K`` rows of ``vals`` ``[K, N]``."""
    global LAUNCHES
    _check_offsets(offsets, n_out)
    if vals.device.type != "cuda" or offsets.device != vals.device:
        raise ValueError("shuffle_reduce: vals and offsets must be on one CUDA device")
    if vals.dtype not in DTYPE_CODES:
        raise TypeError(f"shuffle_reduce: unsupported dtype {vals.dtype}")
    if offsets.dtype != torch.int32:
        raise TypeError("shuffle_reduce: offsets must be int32")
    k, n = vals.shape
    if not 1 <= k <= MAX_ROWS:
        raise ValueError(f"shuffle_reduce: {k} rows, the kernel takes 1 to {MAX_ROWS}")
    vals, stride = rows_of(vals)
    offsets = offsets.contiguous()
    out = torch.empty(k, n_out, dtype=vals.dtype, device=vals.device)
    if n_out == 0:
        return out
    if split is None and split_windows(n):
        split = launch_split(offsets, n)
    ptrs, n_chunks, n_split = (None, None, None), 0, 0
    partial = None
    if split is not None:
        lists = (split.chunks, split.bins, split.first)
        if any(t.device != vals.device or t.dtype != torch.int32 for t in lists):
            raise TypeError("shuffle_reduce: the work list must be int32 on the operands' device")
        lists = tuple(t.contiguous() for t in lists)
        ptrs = tuple(t.data_ptr() for t in lists)
        n_chunks, n_split = lists[0].shape[0], lists[1].shape[0]
        partial = torch.empty(k, n_chunks, dtype=vals.dtype, device=vals.device)
    rc = _lib()(vals.data_ptr(), k, stride, n, offsets.data_ptr(), out.data_ptr(), n_out,
                ptrs[0], n_chunks, ptrs[1], ptrs[2], n_split, SPLIT_LEN,
                None if partial is None else partial.data_ptr(),
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
    if perm is None:
        return shuffle_reduce_sorted(vals, offsets, n_out, op, one_bin_split(idx, idx.shape[0]))
    return shuffle_reduce_sorted(vals[perm], offsets, n_out, op)


def shuffle_reduce_batched(vals: torch.Tensor, idx: torch.Tensor, n_out: int,
                           op: str = "+") -> torch.Tensor:
    """Scatter-reduce each row of ``[K, N]`` values into ``n_out`` bins:
    ``[K, n_out]``, row ``k`` equal to ``shuffle_reduce(vals[k], idx[k],
    n_out, op)`` (the reference's ``ops.shuffle_reduce_batched``).

    ``idx`` ``[N]`` is shared by the rows: routed once (one sort, or none
    for a broadcast index), then one batched launch over its offsets.
    ``idx`` ``[K, N]`` differs per row: routed per row, as one stream whose
    row ``k`` fills bins ``k * n_out ..`` (indices outside ``[0, n_out)``
    are dropped, never spilled into the next row), then one launch."""
    if vals.dim() != 2 or idx.shape[-1] != vals.shape[1] or idx.dim() not in (1, 2):
        raise ValueError(f"shuffle_reduce_batched: vals {tuple(vals.shape)} and idx "
                         f"{tuple(idx.shape)} do not line up")
    k = vals.shape[0]
    if vals.device.type == "cpu":
        check_op(op, vals.dtype, "shuffle_reduce")
        return ref.shuffle_reduce_batched_ref(vals, idx, n_out, op)
    if idx.dim() == 2:
        flat = ref.row_bins(idx, k, n_out)
        return shuffle_reduce(vals.reshape(-1), flat, k * n_out, op).view(k, n_out)
    perm, offsets = route(idx, n_out)
    if perm is None:
        return shuffle_reduce_sorted_batched(vals, offsets, n_out, op,
                                             one_bin_split(idx, idx.shape[0]))
    return shuffle_reduce_sorted_batched(vals.index_select(1, perm), offsets, n_out, op)
