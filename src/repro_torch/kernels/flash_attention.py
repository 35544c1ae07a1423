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
  (batch, kv head, tile of query rows), warp specialised: a producer
  thread streams K and V by TMA into shared-memory rings, and one or two
  consumer warpgroups of 64 rows each (:func:`sm90_form`: two where a kv
  head has more than 64 rows) run both products on the tensor cores
  (``wgmma``, bf16 operands, float32 accumulators; P is rounded to bf16
  before ``P.V``) at the call's exact widths;
- float32 on the card with few query rows per kv head (``group * Lq <=
  DECODE_MAX_ROWS``, or ``Lq == 1``: a decode step): the decode route of
  ``csrc/flash_attention.cu``. A block holds a tile of up to 4 of a kv
  head's rows and one split of the keys (:func:`decode_plan`); in it the
  keys are dealt to teams of lanes that each fold their own partial
  softmax for all the tile's rows, a unit of keys at a time with the next
  unit's loads in flight; the last block of a row tile to finish folds the
  splits' partials in split order (none when there is one split);
- float32 on the card otherwise: the tile route of
  ``csrc/flash_attention.cu``, a register-blocked FlashAttention on the
  CUDA cores (float32 FFMA, the arithmetic of the plain version): a block
  holds a tile of a kv head's query rows, numbered position-major, and
  streams the key tiles any of them sees through two cp.async stages
  (:func:`tile_plan` picks the form of the block, large, mid or small,
  :func:`key_tiles` models the key tiles a block visits);
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
forward is the route above and whose backward is :func:`flash_attention_bwd`.
On the card, bfloat16 runs ``csrc/flash_attention_bwd_sm90.cu`` (three
kernels: ``rowsum(dO o O)``, then dK/dV per key tile, then dQ per query
tile, every product on the tensor cores through ``wgmma``, tiles by TMA),
which takes each row's log-sum-exp from the forward: the bf16 forward
under :class:`FlashAttentionFn` asks the tensor-core kernel for it and
saves it. float32 runs ``csrc/flash_attention_bwd.cu`` (three kernels on
the CUDA cores in float32 FFMA: delta; dK, dV and each key tile's part of
dQ per 64 keys, register-blocked, the query tiles through two cp.async
stages (:func:`bwd_tiles`); the parts summed in key-tile order), which
takes the log-sum-exp that the float32 tile route writes when
:class:`FlashAttentionFn` asks for it. Both log-sum-exps are in the log2
domain of the scaled scores. A direct call without ``lse`` runs the
forward's lse route first. Each source has its own width table
(:func:`bwd_widths`). On the CPU the plain twin
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
#: launches of the backward (csrc/flash_attention_bwd_sm90.cu for bfloat16,
#: csrc/flash_attention_bwd.cu for float32) since the last reset; one a
#: call, whose three kernels run in order
BWD_LAUNCHES = 0

HEAD_DIMS = (32, 64, 128, 256)
# route -> (source under csrc/, C entry point)
KERNELS = {"sm90": ("flash_attention_sm90", "repro_flash_attention_sm90"),
           "cuda_core": ("flash_attention", "repro_flash_attention"),
           "decode": ("flash_attention", "repro_flash_attention_decode")}
# source -> its C entry point that names the instantiation a (Dqk, Dv) runs at
WIDTHS = {"flash_attention_sm90": "repro_flash_attention_sm90_widths",
          "flash_attention": "repro_flash_attention_widths",
          "flash_attention_bwd_sm90": "repro_flash_attention_bwd_sm90_widths",
          "flash_attention_bwd": "repro_flash_attention_bwd_widths"}
# the backward's source by dtype
BWD_SOURCES = {torch.bfloat16: "flash_attention_bwd_sm90", torch.float32: "flash_attention_bwd"}

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
DECODE_WAVES = 1
#: ... but a split reads at least this many bytes of K and V
DECODE_SPLIT_BYTES = 1 << 18
DECODE_THREADS = 256  # threads of a decode block (csrc/flash_attention.cu: kDecodeThreads)
DECODE_ROWS = 4  # query rows a decode block holds at most (kDecodeRowsMax)

# key groups of a tile-route block (csrc/flash_attention.cu: kGroups), and
# its forms: row groups (``RG``; threads: RG x 16) and (R, C), the rows a
# thread holds and the keys it scores, by Q/K width (Tile<DK, DV, F>)
TILE_GROUPS = 16
TILE_FORMS = ("large", "mid", "small")


def tile_form(dh: int, form: str) -> Optional[Tuple[int, int, int]]:
    """``(RG, R, C)`` of a tile-route block of ``form`` at Q/K width ``dh``
    (an instantiated width): large 16 row groups of 8 x 4 up to 128, 4 x 2
    up to 256, 2 x 1 wider; mid 8 row groups of 4 x 2, up to 256 (``None``
    wider: its shared memory would not fit); small 16 of 1 x 1."""
    if form == "large":
        return (16, 8, 4) if dh <= 128 else (16, 4, 2) if dh <= 256 else (16, 2, 1)
    if form == "mid":
        return (8, 4, 2) if dh <= 256 else None
    if form == "small":
        return 16, 1, 1
    raise ValueError(f"tile_form: no form {form!r}; choose from {TILE_FORMS}")


def tile_threads(form: str) -> int:
    """Threads of a tile-route block of ``form``: its row groups x 16."""
    return tile_form(32, form)[0] * TILE_GROUPS


# batch, heads, kv_heads, lq, lk, dqk, dv, strides, causal, window, scale
_SHAPE = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 2 + [
    ctypes.c_float]
# q, k, v, out (and for sm90 and the tile route lse), the shape, then the
# tile route's row tile, or the decode route's scratch (partial acc, partial
# (m, l), counters), row tile, n_splits, chunk; the stream last
_ARGTYPES = {"sm90": [ctypes.c_void_p] * 5 + _SHAPE + [ctypes.c_void_p],
             "cuda_core": [ctypes.c_void_p] * 5 + _SHAPE + [ctypes.c_int, ctypes.c_void_p],
             "decode": [ctypes.c_void_p] * 4 + _SHAPE + [ctypes.c_void_p] * 3
             + [ctypes.c_int] * 3 + [ctypes.c_void_p]}
#: the routes whose kernel writes each row's log-sum-exp when asked
LSE_ROUTES = ("sm90", "cuda_core")


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


def tile_shape(dh: int, form: str) -> Optional[Tuple[int, int]]:
    """``(BM, BN)`` of a tile-route block of ``form`` at Q/K width ``dh``
    (``csrc/flash_attention.cu``, ``Tile<DK, DV, F>``): its query rows (row
    groups x R) and the keys of its key tiles (16 x C); ``None`` where the
    form is not instantiated (mid above 256). The bounds are instantiated
    widths, so a pair gets the tile of the instantiation it runs at."""
    f = tile_form(dh, form)
    return None if f is None else (f[0] * f[1], TILE_GROUPS * f[2])


def _qk_row_floats(dh: int) -> int:
    """Floats a Q/K row of width ``dh`` takes in a tile block's shared
    memory (``QkRow<DH>``): ``dh`` where its 16-byte chunks are a multiple
    of 8 (swizzled), else padded to an odd number of chunks (80: 84)."""
    chunks = dh // 4
    return dh if chunks % 8 == 0 else 4 * (chunks | 1)


def tile_smem_bytes(dh: int, form: str, dv: Optional[int] = None) -> int:
    """Dynamic shared memory of a tile-route block of ``form`` at widths
    ``dh`` (Q and K) and ``dv`` (V; ``None``: ``dh``), an instantiation's:
    Q ``[BM, QS]``, two stages each of K ``[BN, QS]`` and V ``[BN, dv]``,
    and P ``[BN, BM + 4]``, float32; ``QS`` the row of :func:`_qk_row_floats`."""
    bm, bn = tile_shape(dh, form)
    dv = dh if dv is None else dv
    qs = _qk_row_floats(dh)
    return 4 * (bm * qs + 2 * bn * qs + 2 * bn * dv + bn * (bm + 4))


def tile_plan(batch: int, kv_heads: int, rows: int, dh: int, n_sm: int) -> Tuple[int, int, int]:
    """``(BM, BN, tiles)`` of a tile-route call, from the shape and the card
    alone: ``rows`` query rows of each of ``batch x kv_heads`` kv heads cut
    into ``tiles`` tiles of ``BM``. The large tile while its blocks give
    each of the ``n_sm`` SMs one; else the mid tile while its blocks (of
    half the threads, two an SM) reach at least half the SMs (MLA's f32
    layer forward: 128 kv heads of 64 rows, 256 blocks; zamba2's: 64 of 64,
    128); else the small one, whose blocks are more and shorter
    (qwen3-0.6b's 16-token forward: 2 x 8 kv heads of 32 rows, 32 blocks)."""
    heads = batch * kv_heads
    bm, bn = tile_shape(dh, "large")
    if heads * -(-rows // bm) < n_sm:
        mid = tile_shape(dh, "mid")
        if mid is not None and 2 * heads * -(-rows // mid[0]) >= n_sm:
            bm, bn = mid
        else:
            bm, bn = tile_shape(dh, "small")
    return bm, bn, -(-rows // bm)


def plan_form(dh: int, bm: int) -> str:
    """The form whose blocks hold ``bm`` rows at Q/K width ``dh``."""
    return next(f for f in TILE_FORMS if (tile_shape(dh, f) or (0,))[0] == bm)


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
    chunks in at most 4 a lane, 32 at most) holds one key row, ``vec``
    chunks a lane (the last
    lanes of a row that is no multiple of them hold zeros), the block's
    ``teams`` teams take the keys of their split in turn, and a team folds
    ``unit = 4 // vec`` keys at a time (at least one), loading the next
    unit into registers before it folds this one."""
    k4 = dh // 4
    lanes = 8 if k4 <= 32 else 16 if k4 <= 64 else 32
    vec = -(-k4 // lanes)
    return lanes, DECODE_THREADS // lanes, max(1, 4 // vec)


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
    (32 blocks, Dh 128) one split below 512 keys, 4 at 4,096; at h2o's ring
    (8 blocks, Dh 120 at 128) 16 splits of 256 keys."""
    want = min(DECODE_WAVES * n_sm // max(blocks, 1), lk // _least_split(dh))
    return split_chunk(lk, max(1, want))


def decode_row_tile(rows: int, kv_heads: int, lk: int, dh: int, n_sm: int) -> int:
    """Query rows a decode block holds (its ``R``, one of 1, 2 and 4, which
    ``csrc/flash_attention.cu`` instantiates) for ``rows`` rows of each of
    ``kv_heads`` (batch x kv heads) over ``lk`` keys: the least that holds
    the rows (4 at most), halved while the blocks, even cut into the most
    splits ``lk`` allows, would reach fewer than half the ``n_sm`` SMs. At
    a short cache fewer rows a block (K and V then read once a tile, from
    L2) finish sooner; at a long one the splits fill the card and R stays
    (h2o-danube's ring: 8 kv heads of 4 rows, 16 splits, 128 blocks)."""
    r = 1
    while r < min(rows, DECODE_ROWS):
        r *= 2
    most = max(1, lk // _least_split(dh))
    while r > 1 and 2 * kv_heads * -(-rows // r) * most < n_sm:
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


# (device, stream) -> the decode route's int32 counters, one a row tile
_COUNTERS: dict = {}


def _decode_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 counters for the decode route's calls on
    ``stream``, all 0: each call's last block of a row tile sets its
    counter back to 0, so the buffer is zeroed once and kept (grown when a
    call needs more); calls on one stream run in order, so they share it."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf


def tile_occupancy(dqk: int, dv: int, bm: int) -> int:
    """Blocks of the tile route's kernel for ``(dqk, dv)`` whose blocks hold
    ``bm`` rows that one SM of the current device holds at once, as the CUDA
    runtime computes them from the kernel's registers, threads and shared
    memory (``repro_flash_attention_tile_occupancy``). Builds the source on
    first use."""
    fn = _build.load(KERNELS["cuda_core"][0]).repro_flash_attention_tile_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int()
    rc = fn(dqk, dv, bm, ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"tile_occupancy({dqk}, {dv}, {bm}): CUDA error {rc}")
    return out.value


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


def sm90_form(dqk: int, dv: int, rows: int) -> int:
    """The query rows a block of the tensor-core kernel holds for a
    ``(dqk, dv)`` call whose kv heads have ``rows = group * Lq`` query rows
    each, as the source chooses them (``form_consumers`` in
    ``csrc/flash_attention_sm90.cu``): 128 (two consumer warpgroups of 64
    rows) where a kv head has more than 64 rows and the instantiation takes
    both forms, else 64 (one); ``ValueError`` for a pair the kernel does not
    take. Builds the source on first use."""
    fn = _build.load(KERNELS["sm90"][0]).repro_flash_attention_sm90_form
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    got = fn(dqk, dv, rows)
    if got < 0:
        raise ValueError(f"flash_attention: no sm90 kernel takes head dims (Dqk, Dv) = "
                         f"{(dqk, dv)}")
    return got


@functools.lru_cache(maxsize=None)
def bwd_widths(dqk: int, dv: int, dtype: torch.dtype) -> Tuple[int, int]:
    """``(DK, DV)``: the instantiation a ``(dqk, dv)`` backward in ``dtype``
    runs at (bfloat16: ``csrc/flash_attention_bwd_sm90.cu``, float32:
    ``csrc/flash_attention_bwd.cu``), the narrowest of the source's table
    that holds both, as its widths entry answers; ``ValueError`` where none
    does. Builds the source on first use."""
    source = BWD_SOURCES[dtype]
    fn = getattr(_build.load(source), WIDTHS[source])
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    if fn(dqk, dv, out) != 0:
        raise ValueError(f"flash_attention: no {dtype} backward kernel takes head dims "
                         f"(Dqk, Dv) = {(dqk, dv)}")
    return out[0], out[1]


def bwd_tiles(dk: int) -> Tuple[int, int]:
    """``(keys, rows)`` of the float32 backward at the instantiation of
    Q/K width ``dk`` (``csrc/flash_attention_bwd.cu``, ``Shape<DK, DV>``):
    each of its blocks holds ``keys`` keys (a key tile, whose part of dQ it
    writes) and streams query tiles of ``rows`` rows. A thread holds 4 keys
    against ``rows / 16`` query rows: 4 up to 128, 2 at 192."""
    return 64, 16 * (4 if dk <= 128 else 2)


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
    route, which saves q, k, v and the output (and on the tensor-core and
    float32 tile routes each row's log-sum-exp, which the kernel then
    writes beside the output), the backward :func:`flash_attention_bwd`.
    Arguments: ``(q, k, v, causal, window, scale)``, the scale resolved."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float):
        route = _route(q, q.shape[1] // k.shape[1])
        if route in LSE_ROUTES:
            out, lse = _launch(route, q, k, v, causal, window, scale, with_lse=True)
        else:
            out, lse = _forward(q, k, v, causal, window, scale), None
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attrs = (causal, window, scale)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, *ctx.attrs, lse=lse)
        return dq, dk, dv, None, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None, lse: Optional[torch.Tensor] = None):
    """``(dq, dk, dv)`` of :func:`flash_attention` at ``(q, k, v)`` for the
    output gradient ``dout``, given the forward's output ``out`` (both ``[B,
    H, Lq, Dv]``); each in its input's shape and dtype. A CUDA tensor runs
    ``csrc/flash_attention_bwd_sm90.cu`` (bfloat16) or
    ``csrc/flash_attention_bwd.cu`` (float32) or raises; a CPU tensor the
    plain twin :func:`.ref.flash_attention_bwd_ref`. ``lse``: the
    forward's log-sum-exp of each row (float32 ``[B, H, Lq]``, log2 domain
    of the scaled scores, as :class:`FlashAttentionFn` saves it: the
    tensor-core route's for bfloat16, the tile route's for float32); where
    it is not given, a call on the card first runs that route with it (a
    float32 forward on the decode route saves none). The CPU takes none."""
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
    bwd_widths(dqk, dv, q.dtype)
    if max(b * h * lq, b * hkv * lk) >= 2**31:
        raise ValueError("flash_attention_bwd: sizes past int32")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if lse is None:
        route = "sm90" if q.dtype == torch.bfloat16 else "cuda_core"
        lse = _launch(route, q, k, v, causal, window, scale, with_lse=True)[1]
    if lse.shape != (b, h, lq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be float32 {(b, h, lq)} "
                         f"contiguous, got {lse.dtype} {tuple(lse.shape)}")
    ins = [_aligned(t) for t in (q, k, v, out, dout.to(q.dtype))]
    if q.dtype == torch.bfloat16:
        grads = [_grad_like(t) for t in ins[:3]]
        scratch = torch.empty(_bwd_entry("scratch")(b, h, lq), dtype=torch.float32,
                              device=q.device)
        # q, k, v, out, dout, lse, dq, dk, dv, the scratch
        ptrs = [*(t.data_ptr() for t in ins), lse.data_ptr(),
                *(t.data_ptr() for t in grads), scratch.data_ptr()]
        fn = _bwd_entry("sm90")
    else:
        grads = [_grad_like(t) for t in ins[:3]]
        delta = torch.empty(b * h * lq, dtype=torch.float32, device=q.device)
        part = torch.empty(_bwd_entry("part")(b, h, lq, lk, dqk, dv), dtype=torch.float32,
                           device=q.device)
        # q, k, v, out, dout, dq, dk, dv, lse, the delta and dQ-part scratch
        ptrs = [*(t.data_ptr() for t in ins + grads), lse.data_ptr(), delta.data_ptr(),
                part.data_ptr()]
        fn = _bwd_entry("f32")
    strides = (ctypes.c_int64 * 24)(*(s for t in ins + grads for s in t.stride()[:3]))
    rc = fn(*ptrs, b, h, hkv, lq, lk, dqk, dv, strides, int(causal), int(window), scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {rc}")
    BWD_LAUNCHES += 1
    return tuple(grads)


def _bwd_entry(name: str):
    """A C entry point of the backward sources, its argument types set:
    ``"sm90"`` and ``"f32"`` launch a backward (ten or eleven pointers,
    the shape, the strides, causal, window, scale, the stream),
    ``"scratch"`` gives the floats of the bf16 backward's scratch for
    ``(B, H, Lq)``, ``"part"`` those of the f32 backward's dQ parts for
    ``(B, H, Lq, Lk, Dqk, Dv)``."""
    source, entry = {"sm90": ("flash_attention_bwd_sm90", "repro_flash_attention_bwd_sm90"),
                     "f32": ("flash_attention_bwd", "repro_flash_attention_bwd"),
                     "scratch": ("flash_attention_bwd_sm90",
                                 "repro_flash_attention_bwd_sm90_scratch"),
                     "part": ("flash_attention_bwd", "repro_flash_attention_bwd_part_floats")
                     }[name]
    fn = getattr(_build.load(source), entry)
    if fn.argtypes is None:
        if name in ("scratch", "part"):
            fn.argtypes = [ctypes.c_int] * (3 if name == "scratch" else 6)
            fn.restype = ctypes.c_int64
        else:
            fn.argtypes = [ctypes.c_void_p] * (10 if name == "sm90" else 11) + _SHAPE + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return fn


def _grad_like(t: torch.Tensor) -> torch.Tensor:
    """An empty tensor of ``t``'s shape and dtype laid out as ``t`` is where
    that keeps the last dim contiguous (a ``[B, L, H, D]`` buffer for a
    view of one), else contiguous."""
    g = torch.empty_like(t)
    return g if g.stride(-1) == 1 else torch.empty(t.shape, dtype=t.dtype, device=t.device)


def _launch(route: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, scale: Optional[float] = None, with_lse: bool = False):
    """Run ``route``'s kernel(s) on CUDA tensors whose shapes
    :func:`flash_attention` has checked. :func:`flash_attention` passes the
    route :func:`_route` chose; chip_smoke.py also calls it with the other
    float32 route, to time both at one shape. ``with_lse`` (the ``"sm90"``
    route, Dv at most 256, and the float32 tile route ``"cuda_core"``):
    return ``(out, lse)``, ``lse`` each row's log-sum-exp as the backward
    takes it (float32 ``[B, H, Lq]``, log2 domain of the scaled scores,
    +inf for a row that sees no key); the output is the same bits as
    without it."""
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
    if with_lse and route not in LSE_ROUTES:
        raise ValueError(f"flash_attention: only the routes {LSE_ROUTES} give the "
                         f"log-sum-exp, asked of {route}")
    dk, dv_slice = kernel_widths(route, dh, dv)
    if with_lse and route == "sm90" and dv > dv_slice:
        raise ValueError(f"flash_attention: the log-sum-exp needs Dv <= {dv_slice} (one value "
                         f"slice), got Dv {dv}")
    if max(b * h * lq, lk) >= 2**31:
        raise ValueError("flash_attention: sizes past int32")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = _aligned(_out_like(q, dv))
    lse = torch.empty(b, h, lq, dtype=torch.float32, device=q.device) if with_lse else None
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out) for s in t.stride()[:3]))
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if route in LSE_ROUTES:
        ptrs.append(lse.data_ptr() if with_lse else None)
    args = [*ptrs, b, h, hkv, lq, lk, dh, dv, strides, int(causal), int(window), scale]
    if route == "cuda_core":
        args.append(tile_plan(b, hkv, h // hkv * lq, dk, _sm_count(q.device.index))[0])
    elif route == "decode":
        row_tile, _, n_splits, chunk = decode_plan(b, hkv, h // hkv * lq, lk, dk,
                                                   _sm_count(q.device.index))
        scratch = [0, 0, 0]
        stream = torch.cuda.current_stream(q.device)
        if n_splits > 1:  # each row's partial (acc, then m and l) of every split
            part_acc = torch.empty(b * h * lq, n_splits, dv, dtype=torch.float32,
                                   device=q.device)
            part_ml = torch.empty(b * h * lq, n_splits, 2, dtype=torch.float32,
                                  device=q.device)
            counters = _decode_counters(q.device, stream.cuda_stream,
                                        b * hkv * -(-(h // hkv * lq) // row_tile))
            scratch = [part_acc.data_ptr(), part_ml.data_ptr(), counters.data_ptr()]
        args += [*scratch, row_tile, n_splits, chunk]
    rc = _lib(route)(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention ({route}) kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    if route == "sm90":
        SM90_LAUNCHES += 1
    elif route == "decode":
        DECODE_LAUNCHES += 1
    return (out, lse) if with_lse else out
