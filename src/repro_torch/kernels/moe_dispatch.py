"""MoE dispatch: the hand-written CUDA kernel ``csrc/moe_gather.cu``.

Replaces the reference package's Pallas TPU kernel
``kernels/moe_dispatch.py::moe_gather_call`` (and its wrapper
``kernels/ops.py::moe_gather``). What bounds it on an H100 is bytes: one
write of every output row and one read of every live token row. The
design (one block per output row, the index loads issued together, every
load of a pass issued before its stores, 16-byte copies along D, zero rows
stored without loads, offsets and rows clamped into their arrays) is
described in the CUDA source.

:func:`moe_gather` takes the reference's form (``tokens_sorted [T, D]``,
``[E]`` offsets and sizes) and the MoE layer's grouped, fused form
(``[G, T, D]`` token tables, ``[G, E]`` offsets and sizes, and the
expert-sorted token row of each assignment), which gathers through the
sort order without writing the sorted tokens. Offsets need not be
multiples of a block.

A CPU tensor takes the plain version in :mod:`.ref`; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, ref

#: launches of the CUDA kernel since the last reset (set it to 0 to reset)
LAUNCHES = 0

# x, rows, offsets, sizes, out, groups, tokens, stream_len, experts, capacity,
# row_bytes, stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]


def _lib():
    lib = _build.load("moe_gather")
    fn = lib.repro_moe_gather
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def moe_gather(tokens: torch.Tensor, offsets: torch.Tensor, sizes: torch.Tensor,
               capacity: int, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[g, e, c] = tokens[g, rows[g, offsets[g, e] + c]]`` for
    ``c < sizes[g, e]``, zeros elsewhere; ``rows=None`` reads the token
    table in order. Shapes: ``tokens [G, T, D]``, ``offsets``/``sizes
    [G, E]``, ``rows [G, R]`` -> ``[G, E, C, D]`` in tokens' dtype; or,
    without the group dim, ``[T, D]`` and ``[E]`` -> ``[E, C, D]``.
    Matches :func:`.ref.moe_gather_ref`."""
    global LAUNCHES
    grouped = tokens.dim() == 3
    if not grouped:
        if tokens.dim() != 2 or offsets.dim() != 1:
            raise ValueError(f"moe_gather: tokens [T, D] with offsets [E], or [G, T, D] with "
                             f"[G, E]; got {tuple(tokens.shape)}, {tuple(offsets.shape)}")
        out = moe_gather(tokens[None], offsets[None], sizes[None], capacity,
                         None if rows is None else rows[None])
        return out[0]
    g, t, d = tokens.shape
    if offsets.dim() != 2 or offsets.shape[0] != g or sizes.shape != offsets.shape:
        raise ValueError(f"moe_gather: offsets and sizes must be [G={g}, E], got "
                         f"{tuple(offsets.shape)}, {tuple(sizes.shape)}")
    if rows is not None and (rows.dim() != 2 or rows.shape[0] != g):
        raise ValueError(f"moe_gather: rows must be [G={g}, R], got {tuple(rows.shape)}")
    if capacity < 1:
        raise ValueError(f"moe_gather: capacity must be >= 1, got {capacity}")
    if tokens.device.type == "cpu":
        return ref.moe_gather_ref(tokens, rows, offsets, sizes, capacity)
    index = [offsets, sizes] + ([] if rows is None else [rows])
    if tokens.device.type != "cuda" or any(a.device != tokens.device for a in index):
        raise ValueError("moe_gather: all tensors must be on one CUDA device")
    if any(a.dtype != torch.int32 for a in index):
        raise TypeError("moe_gather: offsets, sizes and rows must be int32")
    e = offsets.shape[1]
    if g * e * capacity >= 2**31:
        raise ValueError("moe_gather: more than 2^31 - 1 output rows")
    tokens = tokens.contiguous()
    offsets, sizes = offsets.contiguous(), sizes.contiguous()
    rows = None if rows is None else rows.contiguous()
    out = torch.empty((g, e, capacity, d), dtype=tokens.dtype, device=tokens.device)
    if out.numel() == 0:
        return out
    rc = _lib()(tokens.data_ptr(), None if rows is None else rows.data_ptr(),
                offsets.data_ptr(), sizes.data_ptr(), out.data_ptr(), g, t,
                t if rows is None else rows.shape[1], e, capacity,
                d * tokens.element_size(), torch.cuda.current_stream(tokens.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_gather kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
