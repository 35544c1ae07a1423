"""Flash attention: two hand-written CUDA kernels, chosen by dtype.

Replaces the reference package's Pallas TPU kernel
``kernels/flash_attention.py::flash_attention_call`` (and its wrapper
``kernels/ops.py::flash_attention``). What bounds it on an H100: bytes at
decode (the KV cache read once), operations at prefill. Both kernels take
one block per (batch, kv head, 64 query rows) with GQA inside the kernel
and a float32 online softmax; they take no TPU tile knobs
(``block_q``/``block_k``). The route follows from the dtype alone
(:func:`_route`); it is not a knob, and nothing falls back from one kernel
to the other:

- bfloat16 on the card: ``csrc/flash_attention_sm90.cu``, both products on
  the tensor cores (``wgmma``, bf16 operands, float32 accumulators; P is
  rounded to bf16 before ``P.V``), K/V by TMA into two shared-memory
  stages;
- float32 on the card: ``csrc/flash_attention.cu``, float32 products on
  the CUDA cores (the arithmetic of the plain version);
- a CPU tensor: the plain version in :mod:`.ref`.

Strides are passed to the kernels, so a ``[B, L, H, Dh]`` activation or a
``[B, buf, Hkv, Dh]`` KV cache viewed as ``[B, H, L, Dh]`` (a transpose)
is read in place; only a last dim that is not contiguous, or a base or
stride that is not a multiple of 16 bytes (the kernels' 16-byte copies
and TMA's tensor maps), is copied first.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, ref

#: launches of either CUDA kernel since the last reset (set it to 0 to reset)
LAUNCHES = 0
#: launches of the tensor-core kernel (bfloat16) since the last reset
SM90_LAUNCHES = 0

HEAD_DIMS = (32, 64, 128, 256)
# route -> (source under csrc/, C entry point)
KERNELS = {"sm90": ("flash_attention_sm90", "repro_flash_attention_sm90"),
           "cuda_core": ("flash_attention", "repro_flash_attention")}

# q, k, v, out, batch, heads, kv_heads, lq, lk, dh, strides, causal, window, scale,
# stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int64)]
             + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])


def _route(q) -> str:
    """Which kernel computes attention for ``q``, from its device type and
    dtype alone: ``"sm90"`` (bfloat16 on the card), ``"cuda_core"``
    (float32 on the card) or ``"plain"`` (the CPU)."""
    if q.device.type == "cpu":
        return "plain"
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device type {q.device.type!r}")
    if q.dtype == torch.bfloat16:
        return "sm90"
    if q.dtype == torch.float32:
        return "cuda_core"
    raise TypeError(f"flash_attention: q must be float32 or bfloat16, got {q.dtype}")


def _lib(route: str):
    source, entry = KERNELS[route]
    fn = getattr(_build.load(source), entry)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its last dim is contiguous and its base and every
    other stride are positive multiples of 16 bytes (the kernels' 16-byte
    copies and TMA's tensor maps), else a contiguous copy."""
    size = t.element_size()
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s > 0 and s * size % 16 == 0 for s in t.stride()[:-1]))
    return t if ok else t.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Softmax attention of ``q [B, H, Lq, Dh]`` over ``k, v [B, Hkv, Lk,
    Dh]`` (``H`` a multiple of ``Hkv``), output ``[B, H, Lq, Dh]`` in q's
    dtype with q's memory layout. Query ``i`` sits at position
    ``Lk - Lq + i``; ``window > 0`` keeps keys ``> position - window``.
    Matches :func:`.ref.flash_attention_ref` (in bfloat16 within bf16's
    rounding: the products take bf16 operands)."""
    global LAUNCHES, SM90_LAUNCHES
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B, H, Lq, Dh] and k, v [B, Hkv, Lk, Dh], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    route = _route(q)
    if route == "plain":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must be on one CUDA device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in {HEAD_DIMS}")
    if max(b * h * lq, lk) >= 2**31:
        raise ValueError("flash_attention: sizes past int32")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = _aligned(torch.empty_like(q))
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    rc = _lib(route)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv, lq,
                     lk, dh, strides, int(causal), int(window), 1.0 / math.sqrt(dh),
                     torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention ({route}) kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    if route == "sm90":
        SM90_LAUNCHES += 1
    return out
