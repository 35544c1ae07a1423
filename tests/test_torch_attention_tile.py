"""The float32 tile route's schedule, held to the reference on the CPU.

``csrc/flash_attention.cu``'s tile route numbers a kv head's query rows
position-major, cuts them into tiles of ``BM`` rows (the large, the mid or
the small tile, :func:`flash_attention.tile_plan`), and lets each tile walk
the key tiles of ``BN`` keys that any of its rows sees, masking key by key
only where a key tile is not inside every row's keys
(:func:`flash_attention.key_tiles`), with an online softmax rescaled once
a key tile. The CUDA kernel runs only on the card
(``tests/test_torch_gpu.py``); here ``ref.flash_attention_tile_ref`` takes
the same steps in plain PyTorch and is held to the reference's Pallas
kernel in interpret mode within the reference tests' ``2e-3`` and to the
port's plain version within ``1e-5`` (both are float32; only the order of
the sums differs).
"""
import itertools
import re

import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as fa

H100_SMS = 132
SMEM_LIMIT = 232448  # shared memory a block may use on sm_90 (227 KB)
MASKS = [(True, 0), (False, 0), (True, 8)]
HKV = 2
# the head dims: HEAD_DIMS (Dqk == Dv) by value, then the (Dqk, Dv) pairs of
# the other LM configs (hubert's 80, h2o-danube's 120, MLA's prefill and
# absorbed decode, the smoke MLA's)
CONFIG_PAIRS = [(80, 80), (120, 120), (192, 128), (576, 512), (48, 32), (80, 64)]
DIMS = list(fa.HEAD_DIMS) + [pytest.param(p, id=f"{p[0]}x{p[1]}") for p in CONFIG_PAIRS]


def _dims(dh):
    """(Dqk, Dv) of a DIMS entry."""
    return dh if isinstance(dh, tuple) else (dh, dh)


def _case(b, group, lq, lk, dh, seed):
    dqk, dv = _dims(dh)
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, HKV * group, lq, dqk)).astype(np.float32)
    k = rng.normal(size=(b, HKV, lk, dqk)).astype(np.float32)
    v = rng.normal(size=(b, HKV, lk, dv)).astype(np.float32)
    return q, k, v


def _forms(dh):
    """The forms instantiated at Q/K width ``dh`` (no mid above 256)."""
    return [f for f in fa.TILE_FORMS if fa.tile_shape(dh, f) is not None]


def _form(small):
    """The form a test's ``small`` flag names (its cases predate the mid form)."""
    return "small" if small else "large"


def _model(q, k, v, causal, window, form, rescale=True):
    bm, bn = fa.tile_shape(q.shape[-1], form)
    return ref.flash_attention_tile_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                                        window, bm=bm, bn=bn, rescale=rescale).numpy()


def _plain(q, k, v, causal, window):
    return ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                                   window).numpy()


def _pallas(q, k, v, causal, window):
    """The reference's kernel, which takes one head dim: values narrower
    than the keys are padded with zero columns, and the output cut back."""
    dv = v.shape[-1]
    vp = np.pad(v, [(0, 0)] * 3 + [(0, q.shape[-1] - dv)])
    return np.asarray(ref_ops.flash_attention(q, k, vp, causal=causal, window=window,
                                              block_q=64, block_k=64, interpret=True))[..., :dv]


def _allowed(group, lq, lk, causal, window):
    """[rows, keys] mask of a kv head's position-major rows (brute force)."""
    pos = np.arange(group * lq) // group + (lk - lq)
    kp = np.arange(lk)
    ok = np.ones((group * lq, lk), dtype=bool)
    if causal:
        ok &= kp[None, :] <= pos[:, None]
    if window > 0:
        ok &= kp[None, :] > pos[:, None] - window
    return ok


# --------------------------------------------------------------------------
# the tile plan and the keys a block visits
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dh", DIMS)
@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("causal,window", MASKS + [(False, 5), (True, 1)])
def test_key_tiles_hold_every_unmasked_pair(dh, small, causal, window):
    """Against a brute-force mask, for query and key lengths around the
    tiles (Lk below, equal to and above Lq, rows not a multiple of the
    tile): every unmasked (query, key) pair of a block's rows lies in a key
    tile it visits; no visited key tile is masked for every row of the
    block; a tile marked inside has no masked pair among the block's rows;
    and the visited tiles are consecutive."""
    _check_key_tiles(*fa.tile_shape(_dims(dh)[0], _form(small)), causal, window)


@pytest.mark.parametrize("dh", [p for p in DIMS if _dims(getattr(p, "values", [p])[0])[0] <= 256])
@pytest.mark.parametrize("causal,window", MASKS + [(False, 5), (True, 1)])
def test_key_tiles_hold_every_unmasked_pair_mid(dh, causal, window):
    """The same, under the mid tile (32 rows over 32-key tiles)."""
    _check_key_tiles(*fa.tile_shape(_dims(dh)[0], "mid"), causal, window)


def _check_key_tiles(bm, bn, causal, window):
    for group, lq, lk in itertools.product([1, 2, 8], [1, 5, 31, 33, 70, 130],
                                           [1, 31, 64, 65, 200]):
        rows = group * lq
        ok = _allowed(group, lq, lk, causal, window)
        for tile in range(-(-rows // bm)):
            r0, r1 = tile * bm, min((tile + 1) * bm, rows)
            block = ok[r0:r1]
            visited = fa.key_tiles(tile, bm, bn, rows, group, lq, lk, causal, window)
            ts = [t for t, _ in visited]
            assert not ts or ts == list(range(ts[0], ts[-1] + 1))
            seen = np.zeros(lk, dtype=bool)
            for t, inside in visited:
                keys = block[:, t * bn:(t + 1) * bn]
                assert keys.any(), (group, lq, lk, tile, t)
                if inside:
                    assert keys.all() and (t + 1) * bn <= lk, (group, lq, lk, tile, t)
                seen[t * bn:(t + 1) * bn] = True
            assert not (block & ~seen[None, :]).any(), (group, lq, lk, tile)


def test_tile_plan_at_the_paths_shapes():
    """qwen3-0.6b's 2048-token prefill ([4, 16, 2048, 128] over 8 kv heads)
    and the kernel row ([1, 64, 2048, 128] over 8) take the large tile, 128
    rows (1,024 blocks either way); its 16-token forward (2 x 8 kv heads,
    32 rows each) the small one, 16 rows over 16-key tiles (32 blocks), as
    the large tile would give 16 blocks for 132 SMs (and the mid tile 16);
    Dh 256 takes 64 x 32."""
    assert fa.tile_plan(4, 8, 2 * 2048, 128, H100_SMS) == (128, 64, 32)
    assert fa.tile_plan(1, 8, 8 * 2048, 128, H100_SMS) == (128, 64, 128)
    assert fa.tile_plan(2, 8, 2 * 16, 128, H100_SMS) == (16, 16, 2)
    assert fa.tile_plan(4, 8, 2 * 2048, 256, H100_SMS) == (64, 32, 64)
    assert fa.tile_plan(1, 1, 1, 32, H100_SMS) == (16, 16, 1)
    # the other widths, at the instantiation each runs at: h2o-danube's f32
    # forward over 4,160 tokens (32 heads over 8, Dh 120 at 128) takes the
    # large tile; deepseek-v2's MLA prefill ([1, 128, 2048] over 128 kv heads,
    # (192, 128)) 64 x 32; MLA's latent (576, 512) 32 x 16, and the small tile
    # where blocks are few
    assert fa.tile_plan(1, 8, 4 * 4160, 128, H100_SMS) == (128, 64, 130)
    assert fa.tile_plan(1, 128, 2048, 192, H100_SMS) == (64, 32, 32)
    assert fa.tile_plan(4, 1, 128 * 16, 576, H100_SMS) == (32, 16, 64)
    assert fa.tile_plan(1, 1, 128, 576, H100_SMS) == (16, 16, 8)
    # the mid tile: MLA's f32 layer forward ([1, 128, 64] at (192, 128): the
    # large tile would give 128 blocks) and zamba2's ([2, 32, 64] at (80,
    # 80): 64) take 32 rows over 32-key tiles, 256 and 128 blocks of 128
    # threads; qwen3's 16-token forward stays small (mid: 16 blocks)
    assert fa.tile_plan(1, 128, 64, 192, H100_SMS) == (32, 32, 2)
    assert fa.tile_plan(2, 32, 64, 80, H100_SMS) == (32, 32, 2)
    assert fa.plan_form(192, 32) == fa.plan_form(80, 32) == "mid"
    assert fa.plan_form(128, 16) == "small" and fa.plan_form(128, 128) == "large"


@pytest.mark.parametrize("dh", DIMS)
def test_tile_plan_keeps_its_limits(dh):
    """The large tile whenever its blocks give every SM one, else the mid
    tile (up to 256) whenever its blocks reach half the SMs, else the
    small; the tiles hold every row; a pure function of its arguments."""
    dqk = _dims(dh)[0]
    big, mid, small = (fa.tile_shape(dqk, f) for f in fa.TILE_FORMS)
    for batch, kv_heads, rows, n_sm in itertools.product([1, 2, 33], [1, 4, 8], [1, 32, 129, 4096],
                                                         [16, 132]):
        bm, bn, tiles = fa.tile_plan(batch, kv_heads, rows, dqk, n_sm)
        assert (bm, bn, tiles) == fa.tile_plan(batch, kv_heads, rows, dqk, n_sm)
        assert tiles * bm >= rows > (tiles - 1) * bm
        large_blocks = batch * kv_heads * -(-rows // big[0])
        mid_blocks = 0 if mid is None else batch * kv_heads * -(-rows // mid[0])
        want = big if large_blocks >= n_sm else mid if 2 * mid_blocks >= n_sm else small
        assert (bm, bn) == want


def test_tile_layout_matches_the_source():
    """The tiles the model and the wrapper take are the kernel's: 16 key
    groups, the large and small forms 16 row groups (256 threads), the mid
    8 (128); R x C a thread (large: 8 x 4 up to a Q/K width of 128, 4 x 2
    up to 256, 2 x 1 wider; mid 4 x 2 up to 256; small 1 x 1), a width
    between two bounds taking the tile of the instantiation above it; Q/K
    rows swizzled where their chunks are a multiple of 8, else padded to an
    odd number of chunks (80: 84 floats); and the shared memory of every
    instantiation the configs run at within the 227 KB a block may use, by
    the source's own count."""
    text = (_build.CSRC / "flash_attention.cu").read_text()
    assert re.search(r"constexpr int kGroups = (\d+);", text).group(1) == str(fa.TILE_GROUPS)
    assert "static constexpr int RG = F == kMid ? 8 : 16;" in text
    assert "kThreads = RG * kGroups;" in text
    assert "R = F == kSmall ? 1 : F == kMid ? 4 : (DK <= 128 ? 8 : DK <= 256 ? 4 : 2);" in text
    assert "C = F == kSmall ? 1 : F == kMid ? 2 : (DK <= 128 ? 4 : DK <= 256 ? 2 : 1);" in text
    assert "BM = RG * R;" in text and "BN = kGroups * C;" in text
    assert "PS = BM + 4;" in text
    assert "kSmemFloats = BM * QS + 2 * BN * QS + 2 * BN * DV + BN * PS;" in text
    assert "kSwizzle = kChunks % 8 == 0;" in text
    assert "kStride = kSwizzle ? DH : 4 * (kChunks | 1);" in text
    assert "X(80, 80)" in text
    assert [fa.tile_threads(f) for f in fa.TILE_FORMS] == [256, 128, 256]
    for dk, dv in [(d, d) for d in fa.HEAD_DIMS] + [(80, 80), (192, 128), (576, 512)]:
        qs = dk if dk // 4 % 8 == 0 else 4 * (dk // 4 | 1)
        for form in _forms(dk):
            rg, r, c = {"large": (16,) + ((8, 4) if dk <= 128 else (4, 2) if dk <= 256
                                          else (2, 1)),
                        "mid": (8, 4, 2), "small": (16, 1, 1)}[form]
            bm, bn = rg * r, 16 * c
            assert fa.tile_shape(dk, form) == (bm, bn)
            assert fa.tile_smem_bytes(dk, form, dv) == \
                4 * (bm * qs + 2 * bn * qs + 2 * bn * dv + bn * (bm + 4))
            assert fa.tile_smem_bytes(dk, form, dv) <= SMEM_LIMIT
    assert _forms(576) == ["large", "small"]
    for dqk, dk in [(120, 128), (48, 64)]:
        assert fa.tile_shape(dqk, "large") == fa.tile_shape(dk, "large")
    assert fa.tile_smem_bytes(128, "large") == 230400
    assert fa.tile_smem_bytes(256, "large") == 205312
    assert fa.tile_smem_bytes(576, "large", 512) == 215296
    assert fa.tile_smem_bytes(192, "mid", 128) == 111104
    assert fa.tile_smem_bytes(80, "large") == 160768
    assert fa.tile_smem_bytes(80, "mid") == 57344


@pytest.mark.parametrize("dh", [32, 64, 80, 128, 192, 256, 576])
def test_qk_rows_meet_no_bank_conflict(dh):
    """The Q/K layout (QkRow): the 8 threads of a quarter-warp that load
    16-byte chunk c of 8 consecutive rows (a tile's keys cg + 16 j) land in
    8 different 16-byte bank groups, at every chunk and row offset; the
    padded rows of 80 keep 16-byte alignment."""
    chunks = dh // 4
    swizzled = chunks % 8 == 0
    stride = fa._qk_row_floats(dh)
    assert stride % 4 == 0 and stride >= dh
    for r0 in range(0, 32, 8):
        for c in range(chunks):
            floats = [r * dh + 4 * (c ^ (r & 7)) if swizzled else r * stride + 4 * c
                      for r in range(r0, r0 + 8)]
            assert len({f // 4 % 8 for f in floats}) == 8, (r0, c)


# --------------------------------------------------------------------------
# the schedule against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dh", DIMS)
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("causal,window", MASKS)
def test_tile_model_matches_pallas(dh, group, causal, window):
    """Every head dim, GQA group 1, 2 and 8 and mask, with query rows that
    are not a multiple of any tile and Lk > Lq (decode alignment), under
    every form of the width: the model within 2e-3 of the Pallas kernel
    and within 1e-5 of the plain version."""
    lq = {1: 130, 2: 70, 8: 20}[group]
    q, k, v = _case(2, group, lq, lq + 37, dh,
                    seed=sum(_dims(dh)) + 10 * group + int(causal) + window)
    plain = _plain(q, k, v, causal, window)
    pallas = _pallas(q, k, v, causal, window)
    np.testing.assert_allclose(plain, pallas, rtol=2e-3, atol=2e-3)
    for form in _forms(_dims(dh)[0]):
        got = _model(q, k, v, causal, window, form)
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5, err_msg=form)
        np.testing.assert_allclose(got, pallas, rtol=2e-3, atol=2e-3, err_msg=form)


@pytest.mark.parametrize("dh", [32, 128])
@pytest.mark.parametrize("lq,lk", [(1, 1), (127, 127), (129, 129), (31, 33), (33, 300)])
def test_tile_model_around_the_tiles(dh, lq, lk):
    """Query lengths one below and one above a tile, one query, and long
    key ranges, causal and windowed, every form: within 1e-5 of the plain
    version."""
    q, k, v = _case(1, 1, lq, lk, dh, seed=lq + lk + dh)
    for (causal, window), form in itertools.product(MASKS, _forms(dh)):
        np.testing.assert_allclose(_model(q, k, v, causal, window, form),
                                   _plain(q, k, v, causal, window), rtol=1e-5, atol=1e-5,
                                   err_msg=f"causal={causal} window={window} {form}")


@pytest.mark.parametrize("dh", [32, 256])
def test_tile_model_zeroes_rows_without_keys(dh):
    """Rows whose keys are all masked come out 0, not NaN: causal with more
    queries than keys (the first rows sit before every key), and no key at
    all; a window of 1 (each row sees one key) matches the plain version."""
    q, k, v = _case(1, 8, 40, 10, dh, seed=3)
    for form in _forms(dh):
        out = _model(q, k, v, True, 0, form)
        assert np.isfinite(out).all()
        assert np.array_equal(out[:, :, :30], np.zeros_like(out[:, :, :30]))
        np.testing.assert_allclose(out, _plain(q, k, v, True, 0), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_model(q, k, v, True, 1, form), _plain(q, k, v, True, 1),
                                   rtol=1e-5, atol=1e-5)
    q, k, v = _case(1, 2, 3, 0, dh, seed=5)
    out = _model(q, k, v, True, 0, "large")
    assert np.array_equal(out, np.zeros_like(out))


def test_tile_rescale_fault_fails_the_check():
    """The model without the per-tile rescale (chip_smoke.py's fault
    control) misses Pallas and the plain version by far more than 2e-3 over
    a long causal prefill, so the check the kernel passes can fail there."""
    q, k, v = _case(1, 2, 300, 300, 128, seed=11)
    plain = _plain(q, k, v, True, 0)
    pallas = _pallas(q, k, v, True, 0)
    for form in fa.TILE_FORMS:
        bad = _model(q, k, v, True, 0, form, rescale=False)
        assert not np.allclose(bad, plain, rtol=2e-3, atol=2e-3)
        assert not np.allclose(bad, pallas, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(_model(q, k, v, True, 0, form), pallas, rtol=2e-3,
                                   atol=2e-3)


@pytest.mark.parametrize("name", ["mla", "zamba2"])
def test_tile_model_at_the_mid_paths(name):
    """MLA's f32 layer forward ([1, 128, 64] at (192, 128), scale
    1/sqrt(192); 16 of its 128 heads here) and zamba2's ([2, 32, 64, 80],
    window 4,096; 8 of 32 heads) under the plan the wrapper takes at the
    full shape (the mid tile): the model within 2e-3 of the Pallas kernel
    and 1e-5 of the plain version; without its rescale it misses both."""
    rng = np.random.default_rng(21)
    # MLA's scale, 1/sqrt(192), is the default for its Dqk
    b, h, dqk, dv, window, full = ((1, 16, 192, 128, 0, (1, 128)) if name == "mla"
                                   else (2, 8, 80, 80, 4096, (2, 32)))
    q = rng.normal(size=(b, h, 64, dqk)).astype(np.float32)
    k = rng.normal(size=(b, h, 64, dqk)).astype(np.float32)
    v = rng.normal(size=(b, h, 64, dv)).astype(np.float32)
    bm, bn, tiles = fa.tile_plan(*full, 64, dqk, H100_SMS)
    assert (bm, bn, tiles) == (32, 32, 2)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    plain = ref.flash_attention_ref(*t, True, window).numpy()
    pallas = _pallas(q, k, v, True, window)
    np.testing.assert_allclose(plain, pallas, rtol=2e-3, atol=2e-3)
    for rescale in (True, False):
        got = ref.flash_attention_tile_ref(*t, True, window, bm=bm, bn=bn,
                                           rescale=rescale).numpy()
        if rescale:
            np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got, pallas, rtol=2e-3, atol=2e-3)
        else:
            assert not np.allclose(got, pallas, rtol=2e-3, atol=2e-3)
