"""Flash attention: three hand-written CUDA routes, chosen by dtype and shape.

Replaces the reference package's Pallas TPU kernel
``kernels/flash_attention.py::flash_attention_call`` (and its wrapper
``kernels/ops.py::flash_attention``). What bounds it on an H100: bytes at
decode (the KV cache read once), operations at prefill. Every route keeps
GQA inside the kernel and a float32 online softmax; none takes the TPU
tile knobs (``block_q``/``block_k``). The route follows from the dtype and
the shape alone (:func:`_route`); it is not a knob, and nothing falls back
from one kernel to another:

- bfloat16 on the card: ``csrc/flash_attention_sm90.cu``, one block per
  (batch, kv head, 64 query rows), both products on the tensor cores
  (``wgmma``, bf16 operands, float32 accumulators; P is rounded to bf16
  before ``P.V``), K/V by TMA into two shared-memory stages;
- float32 on the card with few query rows per kv head (``group * Lq <=
  DECODE_MAX_ROWS``, or ``Lq == 1``: a decode step): the decode route of
  ``csrc/flash_attention.cu``. A block holds a tile of up to 8 of a kv
  head's rows and one split of the keys (:func:`decode_plan`); in it the
  keys are dealt to teams of lanes that each fold their own partial
  softmax for all the tile's rows; a second kernel folds the splits'
  partials in split order (none when there is one split);
- float32 on the card otherwise: the tile route of
  ``csrc/flash_attention.cu``, a register-blocked FlashAttention on the
  CUDA cores (float32 FFMA, the arithmetic of the plain version): a block
  holds a tile of a kv head's query rows, numbered position-major, and
  streams the key tiles any of them sees through two cp.async stages
  (:func:`tile_plan` picks the tile, :func:`key_tiles` models the key
  tiles a block visits);
- a CPU tensor: the plain version in :mod:`.ref`.

Strides are passed to the kernels, so a ``[B, L, H, Dh]`` activation or a
``[B, buf, Hkv, Dh]`` KV cache viewed as ``[B, H, L, Dh]`` (a transpose)
is read in place; only a last dim that is not contiguous, or a base or
stride that is not a multiple of 16 bytes (the kernels' 16-byte copies
and TMA's tensor maps), is copied first. The value rows may be narrower
than the key rows (``Dv <= Dqk``, MLA) and may be a view of the keys'
first ``Dv`` columns (MLA's latent cache), which is read in place too.
Each source is instantiated at a few widths and runs a pair at the
narrowest that holds it, with zero columns past Dqk and Dv
(:func:`kernel_widths` asks the source which); a pair that none holds
raises ``ValueError`` on the card.

The gradient: where one is wanted (grad mode on and q, k or v requiring
it) :func:`flash_attention` goes through :class:`FlashAttentionFn`, whose
forward is the route above and whose backward is :func:`flash_attention_bwd`:
on the card the hand-written ``csrc/flash_attention_bwd.cu`` (three
kernels: the rows' log-sum-exp and ``rowsum(dO o O)``, then dK/dV per key
tile, then dQ per query tile; float32 FFMA, bf16 or float32 in and out;
its own width table, :func:`bwd_widths`), on the CPU the plain twin
:func:`.ref.flash_attention_bwd_ref`. Without a gradient nothing records a
graph.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _build, ref

#: launches of any CUDA route since the last reset (set it to 0 to reset);
#: one a call, whatever number of kernels the call ran
LAUNCHES = 0
#: launches of the tensor-core kernel (bfloat16) since the last reset
SM90_LAUNCHES = 0
#: launches of the float32 decode route since the last reset
DECODE_LAUNCHES = 0
#: launches of the backward (csrc/flash_attention_bwd.cu) since the last
#: reset; one a call, whose three kernels run in order
BWD_LAUNCHES = 0

HEAD_DIMS = (32, 64, 128, 256)
# route -> (source under csrc/, C entry point)
KERNELS = {"sm90": ("flash_attention_sm90", "repro_flash_attention_sm90"),
           "cuda_core": ("flash_attention", "repro_flash_attention"),
           "decode": ("flash_attention", "repro_flash_attention_decode")}
# source -> its C entry point that names the instantiation a (Dqk, Dv) runs at
WIDTHS = {"flash_attention_sm90": "repro_flash_attention_sm90_widths",
          "flash_attention": "repro_flash_attention_widths"}

#: float32 attention takes the decode route when ``group * Lq`` (the query
#: rows of one kv head) is at most this, and always at ``Lq == 1``.
#: chip_smoke.py's ``route_sweep`` on the H100 (PERF.md section 6) finds the
#: decode route ahead of the tile route at every row count it times, 2 to
#: 32, by less as the rows grow; 16 (qwen3-0.6b at ``Lq = 8``, Kimi-K2 at
#: ``Lq = 2``) is the most below qwen3's 16-token forward (32 rows), which
#: stays on the tile route.
DECODE_MAX_ROWS = 16
#: the decode route cuts the keys into splits while its blocks stay within
#: this many per SM ...
DECODE_WAVES = 4
#: ... but a split reads at least this many bytes of K and V
DECODE_SPLIT_BYTES = 1 << 17
DECODE_THREADS = 256  # threads of a decode block (csrc/flash_attention.cu: kDecodeThreads)
DECODE_ROWS = 8  # query rows a decode block holds at most (kDecodeRowsMax)

# threads of a tile-route block: 16 row groups x 16 key groups
# (csrc/flash_attention.cu: kTileThreads, kGroups)
TILE_THREADS = 256
TILE_GROUPS = 16

# q, k, v, out, batch, heads, kv_heads, lq, lk, dqk, dv, strides, causal, window, scale
_COMMON = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int64)]
           + [ctypes.c_int] * 2 + [ctypes.c_float])
# ..., then the tile route's row tile, or the decode route's scratch (partial
# acc, partial (m, l)), row tile, n_splits, chunk; the stream last
_ARGTYPES = {"sm90": _COMMON + [ctypes.c_void_p],
             "cuda_core": _COMMON + [ctypes.c_int, ctypes.c_void_p],
             "decode": _COMMON + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
             + [ctypes.c_void_p]}


def _route(q, group: int = 1) -> str:
    """Which kernel computes attention for ``q [B, H, Lq, Dh]`` whose heads
    share kv heads in groups of ``group``, from its device type, dtype and
    query rows alone: ``"sm90"`` (bfloat16 on the card), ``"decode"``
    (float32 on the card, ``Lq == 1`` or ``group * Lq <= DECODE_MAX_ROWS``),
    ``"cuda_core"`` (other float32 on the card) or ``"plain"`` (the CPU)."""
    if q.device.type == "cpu":
        return "plain"
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device type {q.device.type!r}")
    if q.dtype == torch.bfloat16:
        return "sm90"
    if q.dtype == torch.float32:
        lq = q.shape[2]
        return "decode" if lq == 1 or group * lq <= DECODE_MAX_ROWS else "cuda_core"
    raise TypeError(f"flash_attention: q must be float32 or bfloat16, got {q.dtype}")


def tile_shape(dh: int, small: bool) -> Tuple[int, int]:
    """``(BM, BN)`` of a tile-route block at Q/K width ``dh``
    (``csrc/flash_attention.cu``, ``Tile<DK, DV, kSmall>``): its query rows
    and the keys of its key tiles. Each of its 16 x 16 threads holds ``R =
    BM / 16`` rows and scores ``C = BN / 16`` keys of a key tile: in the
    large tile 8 x 4 up to 128, 4 x 2 up to 256, 2 x 1 wider (MLA's latent,
    576); 1 x 1 in the small one. The bounds are instantiated widths, so a
    pair gets the tile of the instantiation it runs at."""
    r, c = (1, 1) if small else (8, 4) if dh <= 128 else (4, 2) if dh <= 256 else (2, 1)
    return TILE_GROUPS * r, TILE_GROUPS * c


def tile_smem_bytes(dh: int, small: bool, dv: Optional[int] = None) -> int:
    """Dynamic shared memory of a tile-route block of widths ``dh`` (Q and
    K) and ``dv`` (V; ``None``: ``dh``), an instantiation's: Q ``[BM,
    dh]``, two stages each of K ``[BN, dh]`` and V ``[BN, dv]``, and P
    ``[BN, BM + 4]``, float32."""
    bm, bn = tile_shape(dh, small)
    dv = dh if dv is None else dv
    return 4 * (bm * dh + 2 * bn * dh + 2 * bn * dv + bn * (bm + 4))


def tile_plan(batch: int, kv_heads: int, rows: int, dh: int, n_sm: int) -> Tuple[int, int, int]:
    """``(BM, BN, tiles)`` of a tile-route call, from the shape and the card
    alone: ``rows`` query rows of each of ``batch x kv_heads`` kv heads cut
    into ``tiles`` tiles of ``BM``. The large tile, unless its blocks would
    not give each of the ``n_sm`` SMs one (qwen3-0.6b's 16-token forward:
    2 x 8 blocks); then the small one, whose blocks are more and shorter."""
    bm, bn = tile_shape(dh, False)
    if batch * kv_heads * -(-rows // bm) < n_sm:
        bm, bn = tile_shape(dh, True)
    return bm, bn, -(-rows // bm)


def key_tiles(tile: int, bm: int, bn: int, rows: int, group: int, lq: int, lk: int,
              causal: bool, window: int) -> list:
    """``[(key tile, inside)]`` that a tile-route block visits, in order, as
    the kernel computes them from the shape. The block holds rows ``tile *
    bm`` to ``min((tile + 1) * bm, rows) - 1`` of a kv head, at positions
    ``row // group`` (query ``i`` at key position ``lk - lq + i``). Some
    row sees a key in ``[lo, hi)`` (the keys of the first position's lower
    and the last's upper bound), every row each key in ``[full_lo,
    full_hi)``; the block visits the key tiles of ``bn`` keys (tile ``t``:
    keys ``t * bn`` on) that meet ``[lo, hi)``, and ``inside`` says a tile
    lies in ``[full_lo, full_hi)``, so that no key of it is checked."""
    off = lk - lq
    p_min = tile * bm // group
    p_max = (min((tile + 1) * bm, rows) - 1) // group

    def lo_of(p):
        return max(0, off + p - window + 1) if window > 0 else 0

    def hi_of(p):
        return min(lk, off + p + 1) if causal else lk

    lo, hi, full_lo, full_hi = lo_of(p_min), hi_of(p_max), lo_of(p_max), hi_of(p_min)
    if hi <= lo:
        return []
    return [(t, t * bn >= full_lo and (t + 1) * bn <= full_hi)
            for t in range(lo // bn, (hi - 1) // bn + 1)]


def decode_layout(dh: int) -> Tuple[int, int, int]:
    """``(lanes, teams, unit)`` of a decode block whose key rows are ``dh``
    wide, an instantiation's Q/K width; the values (Dv <= Dqk) take the
    same lanes (``csrc/flash_attention.cu``, ``Decode<DK, DV>``): a team of
    ``lanes`` lanes (8, 16 or 32: the least that holds a key row's 16-byte
    chunks, 32 at most) holds one key row, ``vec`` chunks a lane (the last
    lanes of a row that is no multiple of them hold zeros), the block's
    ``teams`` teams take the keys of their split in turn, and a team folds
    ``unit = 8 // vec`` keys at a time (at least one)."""
    k4 = dh // 4
    lanes = 8 if k4 <= 8 else 16 if k4 <= 16 else 32
    vec = -(-k4 // lanes)
    return lanes, DECODE_THREADS // lanes, max(1, 8 // vec)


def split_chunk(lk: int, splits: int) -> Tuple[int, int]:
    """Cut ``lk`` keys into at most ``splits`` splits of ``chunk =
    ceil(lk / splits)`` keys (the last may be shorter): ``(n_splits,
    chunk)`` with ``n_splits >= 1`` and no split empty (for ``lk == 0``:
    one split, of no key)."""
    chunk = -(-max(lk, 1) // splits)
    return max(1, -(-lk // chunk)), chunk


def _least_split(dh: int) -> int:
    """The fewest keys a split of more than one holds: one round of the
    block's teams, and DECODE_SPLIT_BYTES of K and V (each row counted
    ``dh`` wide)."""
    _, teams, unit = decode_layout(dh)
    return max(teams * unit, DECODE_SPLIT_BYTES // (8 * dh))


def decode_splits(lk: int, blocks: int, dh: int, n_sm: int) -> Tuple[int, int]:
    """The decode route's key splits, from the shape and the card alone:
    ``(n_splits, chunk)`` (see :func:`split_chunk`) for ``lk`` keys at head
    dim ``dh``, where ``blocks`` blocks (batch x kv heads x row tiles) each
    take every split, on a card of ``n_sm`` SMs. As many splits as keep
    the blocks within ``DECODE_WAVES`` per SM (rounded down, so that no
    last wave runs a few blocks alone), but no split under DECODE_SPLIT_BYTES
    of K and V nor under one round of the block's teams: at qwen3's decode
    (32 blocks, Dh 128) one split below 256 keys, 16 at 4,096."""
    want = min(DECODE_WAVES * n_sm // max(blocks, 1), lk // _least_split(dh))
    return split_chunk(lk, max(1, want))


def decode_row_tile(rows: int, kv_heads: int, lk: int, dh: int, n_sm: int) -> int:
    """Query rows a decode block holds (its ``R``, one of 1, 2, 4 and 8,
    which ``csrc/flash_attention.cu`` instantiates) for ``rows`` rows of
    each of ``kv_heads`` (batch x kv heads) over ``lk`` keys: the least
    that holds the rows (8 at most), halved while the blocks, even cut into
    the most splits ``lk`` allows, would not give every one of the ``n_sm``
    SMs a block. A block's warps take its rows one after another, so at a
    short cache fewer rows a block (K and V then read once a tile, from
    L2) finish sooner; at a long one the splits fill the card and R stays."""
    r = 1
    while r < min(rows, DECODE_ROWS):
        r *= 2
    most = max(1, lk // _least_split(dh))
    while r > 1 and kv_heads * -(-rows // r) * most < n_sm:
        r //= 2
    return r


def decode_plan(batch: int, kv_heads: int, rows: int, lk: int, dh: int,
                n_sm: int) -> Tuple[int, int, int, int]:
    """``(row_tile, row_tiles, n_splits, chunk)`` of a decode-route call:
    :func:`decode_row_tile`, the tiles a kv head's ``rows`` rows take, and
    :func:`decode_splits` over the ``batch x kv_heads x row_tiles``
    blocks."""
    r = decode_row_tile(rows, batch * kv_heads, lk, dh, n_sm)
    tiles = -(-rows // r)
    return (r, tiles, *decode_splits(lk, batch * kv_heads * tiles, dh, n_sm))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib(route: str):
    source, entry = KERNELS[route]
    fn = getattr(_build.load(source), entry)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[route]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def kernel_widths(route: str, dqk: int, dv: int) -> Tuple[int, int]:
    """``(DK, DV)``: the widths of the instantiation ``route``'s source runs
    ``(dqk, dv)`` at, the narrowest of its table that holds both (for
    ``"sm90"`` DV is the slice of value columns a block holds), as the
    source's own widths entry answers; ``ValueError`` naming the pair where
    none does. Builds the source on first use."""
    source = KERNELS[route][0]
    fn = getattr(_build.load(source), WIDTHS[source])
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    if fn(dqk, dv, out) != 0:
        raise ValueError(f"flash_attention: no {route} kernel takes head dims (Dqk, Dv) = "
                         f"{(dqk, dv)}")
    return out[0], out[1]


@functools.lru_cache(maxsize=None)
def bwd_widths(dqk: int, dv: int) -> Tuple[int, int]:
    """``(DK, DV)``: the instantiation of ``csrc/flash_attention_bwd.cu`` a
    ``(dqk, dv)`` backward runs at, the narrowest of its table that holds
    both, as its widths entry answers; ``ValueError`` where none does.
    Builds the source on first use."""
    fn = _build.load("flash_attention_bwd").repro_flash_attention_bwd_widths
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    if fn(dqk, dv, out) != 0:
        raise ValueError(f"flash_attention: no backward kernel takes head dims (Dqk, Dv) = "
                         f"{(dqk, dv)}")
    return out[0], out[1]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its last dim is contiguous and its base and every
    other stride are positive multiples of 16 bytes (the kernels' 16-byte
    copies and TMA's tensor maps), else a contiguous copy."""
    size = t.element_size()
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s > 0 and s * size % 16 == 0 for s in t.stride()[:-1]))
    return t if ok else t.contiguous()


def _out_like(q: torch.Tensor, dv: int) -> torch.Tensor:
    """An empty ``[B, H, Lq, Dv]`` in q's dtype whose first three dims lie
    in memory in q's order (a ``[B, L, H, Dv]`` buffer for q viewed from
    ``[B, L, H, Dqk]``)."""
    if dv == q.shape[3]:
        return torch.empty_like(q)
    order = sorted(range(3), key=q.stride, reverse=True)
    out = q.new_empty([q.shape[d] for d in order] + [dv])
    return out.permute(*[order.index(d) for d in range(3)], 3)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention of ``q [B, H, Lq, Dqk]`` over ``k [B, Hkv, Lk,
    Dqk]`` and ``v [B, Hkv, Lk, Dv]`` (``H`` a multiple of ``Hkv``, ``Dv <=
    Dqk``), output ``[B, H, Lq, Dv]`` in q's dtype with q's memory layout.
    Query ``i`` sits at position ``Lk - Lq + i``; ``window > 0`` keeps keys
    ``> position - window``; the scores are scaled by ``scale``
    (``None``: ``1/sqrt(Dqk)``). Matches :func:`.ref.flash_attention_ref`
    (in bfloat16 within bf16's rounding: the products take bf16
    operands)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention: q [B, H, Lq, Dqk], k [B, Hkv, Lk, Dqk] and v "
                         f"[B, Hkv, Lk, Dv], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, lq, dh = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[3] != dh or hkv == 0 or h % hkv or v.shape[3] > dh:
        raise ValueError(f"flash_attention: k {tuple(k.shape)}, v {tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    scale = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale)


def _forward(q, k, v, causal: bool, window: int, scale: float) -> torch.Tensor:
    route = _route(q, q.shape[1] // k.shape[1])
    if route == "plain":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    return _launch(route, q, k, v, causal, window, scale)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with a gradient: the forward is :func:`flash_attention`'s
    route (which saves q, k, v and the output), the backward
    :func:`flash_attention_bwd`. Arguments: ``(q, k, v, causal, window,
    scale)``, the scale resolved."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float):
        out = _forward(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.attrs = (causal, window, scale)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, *ctx.attrs)
        return dq, dk, dv, None, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None):
    """``(dq, dk, dv)`` of :func:`flash_attention` at ``(q, k, v)`` for the
    output gradient ``dout``, given the forward's output ``out`` (both ``[B,
    H, Lq, Dv]``); each in its input's shape and dtype. A CUDA tensor runs
    ``csrc/flash_attention_bwd.cu`` (bfloat16 or float32) or raises; a CPU
    tensor the plain twin :func:`.ref.flash_attention_bwd_ref`."""
    b, h, lq, dqk = q.shape
    hkv, lk, dv = k.shape[1], k.shape[2], v.shape[3]
    if out.shape != (b, h, lq, dv) or dout.shape != out.shape:
        raise ValueError(f"flash_attention_bwd: out and dout must be {(b, h, lq, dv)}, got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)}")
    scale = 1.0 / math.sqrt(dqk) if scale is None else float(scale)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, dout, causal, window, scale)
    global BWD_LAUNCHES
    if q.device.type != "cuda" or any(t.device != q.device for t in (k, v, out, dout)):
        raise ValueError("flash_attention_bwd: all tensors must be on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != q.dtype for t in (k, v, out)):
        raise TypeError(f"flash_attention_bwd: q, k, v, out must share float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}, {out.dtype}")
    bwd_widths(dqk, dv)
    if max(b * h * lq, b * hkv * lk) >= 2**31:
        raise ValueError("flash_attention_bwd: sizes past int32")
    ins = [t if t.stride(-1) == 1 else t.contiguous()
           for t in (q, k, v, out, dout.to(q.dtype))]
    grads = [_grad_like(t) for t in ins[:3]]
    lse = torch.empty(b * h * lq, dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    strides = (ctypes.c_int64 * 24)(*(s for t in ins + grads for s in t.stride()[:3]))
    fn = _build.load("flash_attention_bwd").repro_flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    rc = fn(*(t.data_ptr() for t in ins + grads), lse.data_ptr(), delta.data_ptr(),
            int(q.dtype == torch.bfloat16), b, h, hkv, lq, lk, dqk, dv, strides, int(causal),
            int(window), scale, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {rc}")
    BWD_LAUNCHES += 1
    return tuple(grads)


def _grad_like(t: torch.Tensor) -> torch.Tensor:
    """An empty tensor of ``t``'s shape and dtype laid out as ``t`` is where
    that keeps the last dim contiguous (a ``[B, L, H, D]`` buffer for a
    view of one), else contiguous."""
    g = torch.empty_like(t)
    return g if g.stride(-1) == 1 else torch.empty(t.shape, dtype=t.dtype, device=t.device)


def _launch(route: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, scale: Optional[float] = None) -> torch.Tensor:
    """Run ``route``'s kernel(s) on CUDA tensors whose shapes
    :func:`flash_attention` has checked. :func:`flash_attention` passes the
    route :func:`_route` chose; chip_smoke.py also calls it with the other
    float32 route, to time both at one shape."""
    global LAUNCHES, SM90_LAUNCHES, DECODE_LAUNCHES
    b, h, lq, dh = q.shape
    hkv, lk, dv = k.shape[1], k.shape[2], v.shape[3]
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must be on one CUDA device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if (route == "sm90") != (q.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention: route {route} does not take {q.dtype}")
    dk = kernel_widths(route, dh, dv)[0]
    if max(b * h * lq, lk) >= 2**31:
        raise ValueError("flash_attention: sizes past int32")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = _aligned(_out_like(q, dv))
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv, lq, lk, dh, dv,
            strides, int(causal), int(window), scale]
    if route == "cuda_core":
        args.append(tile_plan(b, hkv, h // hkv * lq, dk, _sm_count(q.device.index))[0])
    elif route == "decode":
        row_tile, _, n_splits, chunk = decode_plan(b, hkv, h // hkv * lq, lk, dk,
                                                   _sm_count(q.device.index))
        scratch = [0, 0]
        if n_splits > 1:  # each row's partial (acc, then m and l) of every split
            part_acc = torch.empty(b * h * lq, n_splits, dv, dtype=torch.float32,
                                   device=q.device)
            part_ml = torch.empty(b * h * lq, n_splits, 2, dtype=torch.float32,
                                  device=q.device)
            scratch = [part_acc.data_ptr(), part_ml.data_ptr()]
        args += [*scratch, row_tile, n_splits, chunk]
    rc = _lib(route)(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention ({route}) kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    if route == "sm90":
        SM90_LAUNCHES += 1
    elif route == "decode":
        DECODE_LAUNCHES += 1
    return out
