"""Flash attention: the hand-written CUDA kernel ``csrc/flash_attention.cu``.

Replaces the reference package's Pallas TPU kernel
``kernels/flash_attention.py::flash_attention_call`` (and its wrapper
``kernels/ops.py::flash_attention``). What bounds it on an H100: bytes at
decode (the KV cache read once), operations at prefill. The design (one
block per (batch, kv head, 64 query rows), GQA inside the kernel, float32
online softmax over K/V tiles staged in shared memory) is described in the
CUDA source. It takes no TPU tile knobs (``block_q``/``block_k``).

Strides are passed to the kernel, so a ``[B, L, H, Dh]`` activation or a
``[B, buf, Hkv, Dh]`` KV cache viewed as ``[B, H, L, Dh]`` (a transpose)
is read in place; only a last dim that is not contiguous, or rows not
aligned for a 4-element vector load, are copied first.

A CPU tensor takes the plain version in :mod:`.ref`; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, ref

#: launches of the CUDA kernel since the last reset (set it to 0 to reset)
LAUNCHES = 0

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)

# q, k, v, out, batch, heads, kv_heads, lq, lk, dh, strides, dtype, causal, window,
# scale, stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int64)]
             + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _vector_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its last dim is contiguous and every row starts on
    a 16-byte boundary (the kernel's vector loads), else a contiguous copy."""
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s % 4 == 0 for s in t.stride()[:-1]))
    return t if ok else t.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Softmax attention of ``q [B, H, Lq, Dh]`` over ``k, v [B, Hkv, Lk,
    Dh]`` (``H`` a multiple of ``Hkv``), output ``[B, H, Lq, Dh]`` in q's
    dtype with q's memory layout. Query ``i`` sits at position
    ``Lk - Lq + i``; ``window > 0`` keeps keys ``> position - window``.
    Matches :func:`.ref.flash_attention_ref`."""
    global LAUNCHES
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B, H, Lq, Dh] and k, v [B, Hkv, Lk, Dh], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must be on one CUDA device")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in {HEAD_DIMS}")
    if max(b * h * lq, lk) >= 2**31:
        raise ValueError("flash_attention: sizes past int32")
    q, k, v = _vector_ready(q), _vector_ready(k), _vector_ready(v)
    out = _vector_ready(torch.empty_like(q))
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv, lq, lk,
                dh, strides, DTYPE_CODES[q.dtype], int(causal), int(window),
                1.0 / math.sqrt(dh), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
