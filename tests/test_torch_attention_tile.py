"""The float32 tile route's schedule, held to the reference on the CPU.

``csrc/flash_attention.cu``'s tile route numbers a kv head's query rows
position-major, cuts them into tiles of ``BM`` rows (the large or the
small tile, :func:`flash_attention.tile_plan`), and lets each tile walk
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


def _model(q, k, v, causal, window, small, rescale=True):
    bm, bn = fa.tile_shape(q.shape[-1], small)
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
    bm, bn = fa.tile_shape(_dims(dh)[0], small)
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
    the large tile would give 16 blocks for 132 SMs; Dh 256 takes 64 x
    32."""
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


@pytest.mark.parametrize("dh", DIMS)
def test_tile_plan_keeps_its_limits(dh):
    """The large tile whenever its blocks give every SM one, else the
    small; the tiles hold every row; a pure function of its arguments."""
    dqk = _dims(dh)[0]
    big, small = fa.tile_shape(dqk, False), fa.tile_shape(dqk, True)
    for batch, kv_heads, rows, n_sm in itertools.product([1, 2, 33], [1, 4, 8], [1, 32, 129, 4096],
                                                         [16, 132]):
        bm, bn, tiles = fa.tile_plan(batch, kv_heads, rows, dqk, n_sm)
        assert (bm, bn, tiles) == fa.tile_plan(batch, kv_heads, rows, dqk, n_sm)
        assert tiles * bm >= rows > (tiles - 1) * bm
        large_blocks = batch * kv_heads * -(-rows // big[0])
        assert (bm, bn) == (big if large_blocks >= n_sm else small)


def test_tile_layout_matches_the_source():
    """The tiles the model and the wrapper take are the kernel's: 256
    threads as 16 x 16 groups, R x C a thread (8 x 4 up to a Q/K width of
    128, 4 x 2 up to 256, 2 x 1 wider, 1 x 1 small), a width between two
    bounds taking the tile of the instantiation above it, and the shared
    memory of every instantiation the configs run at within the 227 KB a
    block may use, by the source's own count."""
    text = (_build.CSRC / "flash_attention.cu").read_text()
    assert re.search(r"constexpr int kTileThreads = (\d+);", text).group(1) == \
        str(fa.TILE_THREADS)
    assert re.search(r"constexpr int kGroups = (\d+);", text).group(1) == str(fa.TILE_GROUPS)
    assert fa.TILE_GROUPS ** 2 == fa.TILE_THREADS
    assert "R = kSmall ? 1 : (DK <= 128 ? 8 : DK <= 256 ? 4 : 2);" in text
    assert "C = kSmall ? 1 : (DK <= 128 ? 4 : DK <= 256 ? 2 : 1);" in text
    assert "BM = kGroups * R;" in text and "BN = kGroups * C;" in text
    assert "PS = BM + 4;" in text
    assert "kSmemFloats = BM * DK + 2 * BN * DK + 2 * BN * DV + BN * PS;" in text
    for dk, dv in [(d, d) for d in fa.HEAD_DIMS] + [(192, 128), (576, 512)]:
        for small in (False, True):
            r, c = (1, 1) if small else (8, 4) if dk <= 128 else (4, 2) if dk <= 256 else (2, 1)
            bm, bn = 16 * r, 16 * c
            assert fa.tile_shape(dk, small) == (bm, bn)
            assert fa.tile_smem_bytes(dk, small, dv) == \
                4 * (bm * dk + 2 * bn * dk + 2 * bn * dv + bn * (bm + 4))
            assert fa.tile_smem_bytes(dk, small, dv) <= SMEM_LIMIT
    for dqk, dk in [(80, 128), (120, 128), (48, 64)]:
        assert fa.tile_shape(dqk, False) == fa.tile_shape(dk, False)
    assert fa.tile_smem_bytes(128, False) == 230400
    assert fa.tile_smem_bytes(256, False) == 205312
    assert fa.tile_smem_bytes(576, False, 512) == 215296


# --------------------------------------------------------------------------
# the schedule against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dh", DIMS)
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("causal,window", MASKS)
def test_tile_model_matches_pallas(dh, group, causal, window):
    """Every head dim, GQA group 1, 2 and 8 and mask, with query rows that
    are not a multiple of either tile and Lk > Lq (decode alignment), under
    the large and the small tile: the model within 2e-3 of the Pallas
    kernel and within 1e-5 of the plain version."""
    lq = {1: 130, 2: 70, 8: 20}[group]
    q, k, v = _case(2, group, lq, lq + 37, dh,
                    seed=sum(_dims(dh)) + 10 * group + int(causal) + window)
    plain = _plain(q, k, v, causal, window)
    pallas = _pallas(q, k, v, causal, window)
    np.testing.assert_allclose(plain, pallas, rtol=2e-3, atol=2e-3)
    for small in (False, True):
        got = _model(q, k, v, causal, window, small)
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5, err_msg=f"small={small}")
        np.testing.assert_allclose(got, pallas, rtol=2e-3, atol=2e-3, err_msg=f"small={small}")


@pytest.mark.parametrize("dh", [32, 128])
@pytest.mark.parametrize("lq,lk", [(1, 1), (127, 127), (129, 129), (31, 33), (33, 300)])
def test_tile_model_around_the_tiles(dh, lq, lk):
    """Query lengths one below and one above a tile, one query, and long
    key ranges, causal and windowed, both tiles: within 1e-5 of the plain
    version."""
    q, k, v = _case(1, 1, lq, lk, dh, seed=lq + lk + dh)
    for (causal, window), small in itertools.product(MASKS, (False, True)):
        np.testing.assert_allclose(_model(q, k, v, causal, window, small),
                                   _plain(q, k, v, causal, window), rtol=1e-5, atol=1e-5,
                                   err_msg=f"causal={causal} window={window} small={small}")


@pytest.mark.parametrize("dh", [32, 256])
def test_tile_model_zeroes_rows_without_keys(dh):
    """Rows whose keys are all masked come out 0, not NaN: causal with more
    queries than keys (the first rows sit before every key), and no key at
    all; a window of 1 (each row sees one key) matches the plain version."""
    q, k, v = _case(1, 8, 40, 10, dh, seed=3)
    for small in (False, True):
        out = _model(q, k, v, True, 0, small)
        assert np.isfinite(out).all()
        assert np.array_equal(out[:, :, :30], np.zeros_like(out[:, :, :30]))
        np.testing.assert_allclose(out, _plain(q, k, v, True, 0), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_model(q, k, v, True, 1, small), _plain(q, k, v, True, 1),
                                   rtol=1e-5, atol=1e-5)
    q, k, v = _case(1, 2, 3, 0, dh, seed=5)
    out = _model(q, k, v, True, 0, False)
    assert np.array_equal(out, np.zeros_like(out))


def test_tile_rescale_fault_fails_the_check():
    """The model without the per-tile rescale (chip_smoke.py's fault
    control) misses Pallas and the plain version by far more than 2e-3 over
    a long causal prefill, so the check the kernel passes can fail there."""
    q, k, v = _case(1, 2, 300, 300, 128, seed=11)
    plain = _plain(q, k, v, True, 0)
    pallas = _pallas(q, k, v, True, 0)
    for small in (False, True):
        bad = _model(q, k, v, True, 0, small, rescale=False)
        assert not np.allclose(bad, plain, rtol=2e-3, atol=2e-3)
        assert not np.allclose(bad, pallas, rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(_model(q, k, v, True, 0, small), pallas, rtol=2e-3,
                                   atol=2e-3)
