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

The gradient: where one is wanted (grad mode on and the tokens requiring
it) :func:`moe_gather` goes through :class:`MoeGatherFn`, whose backward
is the gather's transpose, :func:`moe_gather_bwd`: each token row summed
over the slots that read it, in slot order (``csrc/moe_gather.cu``'s
``repro_moe_gather_bwd`` on the card, over an inverse map that the
wrapper builds with a stable sort; the plain twin
:func:`.ref.moe_gather_bwd_ref` on the CPU).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from . import _build, ref

#: launches of the CUDA kernel since the last reset (set it to 0 to reset)
LAUNCHES = 0
#: launches of the transpose (the gradient's kernel) since the last reset
BWD_LAUNCHES = 0

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
    if torch.is_grad_enabled() and tokens.requires_grad:
        return MoeGatherFn.apply(tokens, offsets, sizes, capacity, rows)
    return _gather(tokens, offsets, sizes, capacity, rows)


def _gather(tokens, offsets, sizes, capacity: int, rows):
    global LAUNCHES
    g, t, d = tokens.shape
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


class MoeGatherFn(torch.autograd.Function):
    """The grouped gather with a gradient for the tokens: forward
    :func:`moe_gather`'s, backward :func:`moe_gather_bwd`. Arguments:
    ``(tokens [G, T, D], offsets, sizes, capacity, rows)``."""

    @staticmethod
    def forward(ctx, tokens, offsets, sizes, capacity: int, rows):
        ctx.save_for_backward(offsets, sizes, rows)
        ctx.capacity, ctx.n_tokens = capacity, tokens.shape[1]
        return _gather(tokens, offsets, sizes, capacity, rows)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        offsets, sizes, rows = ctx.saved_tensors
        return (moe_gather_bwd(dout, offsets, sizes, ctx.capacity, ctx.n_tokens, rows),
                None, None, None, None)


def moe_gather_bwd(dout: torch.Tensor, offsets: torch.Tensor, sizes: torch.Tensor,
                   capacity: int, n_tokens: int,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The transpose of the grouped :func:`moe_gather`: ``dout [G, E, C, D]``
    -> ``dx [G, n_tokens, D]`` in dout's dtype, ``dx[g, t]`` the sum of
    ``dout[g, e, c]`` over the live slots ``(e, c)`` that read token row
    ``t``, in slot order (float32 sums). A CUDA tensor runs
    ``repro_moe_gather_bwd`` (bfloat16 or float32) or raises; a CPU tensor
    the plain twin :func:`.ref.moe_gather_bwd_ref`."""
    global BWD_LAUNCHES
    g, e, cap, d = dout.shape
    if offsets.shape != (g, e) or sizes.shape != (g, e) or cap != capacity:
        raise ValueError(f"moe_gather_bwd: dout {tuple(dout.shape)} does not fit offsets "
                         f"{tuple(offsets.shape)} and capacity {capacity}")
    if dout.device.type == "cpu":
        return ref.moe_gather_bwd_ref(dout, rows, offsets, sizes, capacity, n_tokens)
    if dout.device.type != "cuda" or offsets.device != dout.device:
        raise ValueError("moe_gather_bwd: all tensors must be on one CUDA device")
    if dout.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"moe_gather_bwd: dout must be float32 or bfloat16, got {dout.dtype}")
    if g * max(n_tokens, e * cap) >= 2**31:
        raise ValueError("moe_gather_bwd: sizes past int32")
    perm, tok_off = ref.moe_gather_inverse(offsets, sizes, rows, capacity, n_tokens)
    dout = dout.contiguous()
    dx = torch.empty((g, n_tokens, d), dtype=dout.dtype, device=dout.device)
    if dx.numel() == 0:
        return dx
    fn = _build.load("moe_gather").repro_moe_gather_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [ctypes.c_int,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
    rc = fn(dout.data_ptr(), perm.data_ptr(), tok_off.data_ptr(), dx.data_ptr(), g, n_tokens,
            e * cap, d, int(dout.dtype == torch.bfloat16),
            torch.cuda.current_stream(dout.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"moe_gather_bwd kernel launch failed: CUDA error {rc}")
    BWD_LAUNCHES += 1
    return dx
