"""The float32 decode route's schedule, held to the reference on the CPU.

``csrc/flash_attention.cu``'s decode route cuts the keys into splits
(``kernels/flash_attention.py::decode_splits``), deals each split's keys
to the block's teams of lanes (team ``t`` takes keys ``t``, ``t + teams``,
... a ``unit`` at a time), folds each team's partial ``(m, l, acc)``, then
the teams in team order and the splits in split order. The CUDA kernel
runs only on the card (``tests/test_torch_gpu.py``); here
``ref.flash_attention_split_ref`` takes the same steps in plain PyTorch,
with the layout the wrapper reads of the kernel (``decode_layout``), and
is held to the reference's Pallas kernel in interpret mode within the
reference tests' ``2e-3`` and to the port's plain version within ``1e-5``
(both are float32; only the order of the sums differs).
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
LKS = (1, 2, 31, 32, 33)
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


def _model(q, k, v, causal, window, n_splits, chunk, rescale=True, broken=None):
    _, teams, unit = fa.decode_layout(q.shape[-1])
    return ref.flash_attention_split_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), causal, window, n_splits=n_splits,
        chunk=chunk, teams=teams, unit=unit, rescale=rescale, broken=broken).numpy()


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


def _split_counts(lk, largest):
    """Every distinct ``(n_splits, chunk)`` that asking for 1..largest splits gives."""
    return sorted({fa.split_chunk(lk, s) for s in range(1, largest + 1)})


# --------------------------------------------------------------------------
# the split function
# --------------------------------------------------------------------------


@pytest.mark.parametrize("lk", list(range(0, 70)) + [127, 128, 129, 1000, 4095, 4096, 4097])
def test_split_chunk_cuts_every_key_into_one_split(lk):
    """At least one split, none empty, and every key in exactly one."""
    for asked in range(1, 70):
        n, chunk = fa.split_chunk(lk, asked)
        assert 1 <= n <= asked and chunk >= 1
        owner = [kp // chunk for kp in range(lk)]
        assert owner == sorted(owner) and set(owner) == (set(range(n)) if lk else set())
        assert all(min(lk, (s + 1) * chunk) > s * chunk for s in range(n)) or lk == 0


@pytest.mark.parametrize("dh", DIMS)
def test_decode_splits_keep_their_limits(dh):
    """``decode_splits`` never asks for more blocks than about DECODE_WAVES
    an SM, never cuts a split under DECODE_SPLIT_BYTES of K and V (nor
    under one round of the teams) unless there is one split, and depends
    on nothing but its arguments."""
    dqk = _dims(dh)[0]
    _, teams, unit = fa.decode_layout(dqk)
    least = max(teams * unit, fa.DECODE_SPLIT_BYTES // (8 * dqk))
    for lk, blocks, n_sm in itertools.product([0, 1, 33, 128, 129, 700, 4096, 70000],
                                              [1, 2, 32, 132, 600, 5000], [1, 16, 132]):
        n, chunk = fa.decode_splits(lk, blocks, dqk, n_sm)
        assert (n, chunk) == fa.decode_splits(lk, blocks, dqk, n_sm)
        assert n >= 1 and (n - 1) * chunk < max(lk, 1) <= n * chunk
        assert n <= max(1, -(-fa.DECODE_WAVES * n_sm // blocks))
        if n > 1:
            assert chunk >= least


def test_decode_plan_at_the_paths_shapes():
    """qwen3-0.6b's decode (4 x 8 kv heads, 2 rows each) over the CLI's
    32-slot cache: one split, one row a block (64 blocks); Kimi-K2's (8 rows
    each): two rows a block, 128 blocks. Over a 4,096-key cache the splits
    fill the card in one wave: 4 of 1,024 keys, 128 blocks. h2o-danube's
    ring step (32 heads over 8 kv heads, 4 rows each, over the 4,096-slot
    ring; Dh 120 runs at the 128 instantiation, whose width the wrapper
    passes): all 4 rows a block, 16 splits of 256 keys, 128 blocks."""
    for lk in range(1, 256):
        assert fa.decode_splits(lk, 32, 128, H100_SMS) == (1, lk)
    assert fa.decode_plan(4, 8, 2, 32, 128, H100_SMS) == (1, 2, 1, 32)
    assert fa.decode_plan(4, 8, 8, 32, 128, H100_SMS) == (2, 4, 1, 32)
    assert fa.decode_plan(4, 8, 2, 4096, 128, H100_SMS) == (2, 1, 4, 1024)
    assert fa.decode_plan(4, 8, 8, 4096, 128, H100_SMS) == (4, 2, 2, 2048)
    assert fa.decode_plan(2, 1, 48, 32, 128, H100_SMS) == (1, 48, 1, 32)
    assert fa.decode_plan(1, 8, 4, 4096, 128, H100_SMS) == (4, 1, 16, 256)
    # zamba2's step over its 64-slot ring (2 x 32 kv heads of one row) at
    # its own (80, 80): one split, 64 blocks
    assert fa.decode_plan(2, 32, 1, 64, 80, H100_SMS) == (1, 1, 1, 64)
    # deepseek-v2's absorbed MLA decode: 128 heads over one latent kv head
    # (Dqk 576, Dv 512): over its f32 check's 64 slots one row a block (128
    # blocks, one split); at batch 4 over 32 and 4,096 slots 4 rows a block
    # (128 blocks, one split)
    assert fa.decode_plan(1, 1, 128, 64, 576, H100_SMS) == (1, 128, 1, 64)
    assert fa.decode_plan(4, 1, 128, 32, 576, H100_SMS) == (4, 32, 1, 32)
    assert fa.decode_plan(4, 1, 128, 4096, 576, H100_SMS) == (4, 32, 1, 4096)


@pytest.mark.parametrize("dh", DIMS)
def test_decode_row_tile_keeps_its_limits(dh):
    """R is 1, 2 or 4, holds all the rows when they fit one tile and the
    blocks reach half the card, and is only made smaller while the blocks
    at the most splits the length allows would reach fewer than half the
    SMs."""
    dqk = _dims(dh)[0]
    least = max(fa.decode_layout(dqk)[1] * fa.decode_layout(dqk)[2],
                fa.DECODE_SPLIT_BYTES // (8 * dqk))
    for rows, kv_heads, lk, n_sm in itertools.product([1, 2, 3, 8, 9, 16, 48], [1, 4, 32, 200],
                                                      [0, 32, 4096], [16, 132]):
        r = fa.decode_row_tile(rows, kv_heads, lk, dqk, n_sm)
        assert r in (1, 2, 4)
        full = min(fa.DECODE_ROWS, 1 << (rows - 1).bit_length())
        most = max(1, lk // least)
        assert r == full or 2 * kv_heads * -(-rows // (2 * r)) * most < n_sm
        if 2 * kv_heads * -(-rows // full) * most >= n_sm:
            assert r == full


def test_decode_layout_matches_the_source():
    """The layout the model takes is the kernel's: 256 threads a block, a
    team of 8, 16 or 32 lanes (the least that holds Dqk/4 16-byte chunks
    in at most 4 a lane, 32 at most), 4/vec keys a unit (1 from Dqk 80 up),
    4 rows a block; the configs' other widths lay out as the instantiation
    they run at."""
    text = (_build.CSRC / "flash_attention.cu").read_text()
    assert re.search(r"constexpr int kDecodeThreads = (\d+);", text).group(1) == \
        str(fa.DECODE_THREADS)
    assert re.search(r"constexpr int kDecodeRowsMax = (\d+);", text).group(1) == \
        str(fa.DECODE_ROWS)
    assert "kLanes = kK4 <= 32 ? 8 : kK4 <= 64 ? 16 : 32;" in text
    assert "kVec = (kK4 + kLanes - 1) / kLanes;" in text
    assert "kTeams = kDecodeThreads / kLanes;" in text
    assert "kUnit = 4 / kVec > 0 ? 4 / kVec : 1;" in text
    assert [fa.decode_layout(d) for d in fa.HEAD_DIMS] == [(8, 32, 4), (8, 32, 2), (8, 32, 1),
                                                           (16, 16, 1)]
    assert {p: fa.decode_layout(p[0]) for p in CONFIG_PAIRS} == {
        (80, 80): (8, 32, 1), (120, 120): (8, 32, 1), (192, 128): (16, 16, 1),
        (576, 512): (32, 8, 1), (48, 32): (8, 32, 2), (80, 64): (8, 32, 1)}
    # 80 runs at its own (80, 80), 120 at 128, 48 at 64: each lays out as
    # the instantiation it runs at
    assert [fa.decode_layout(d) for d in (80, 120, 48)] == \
        [fa.decode_layout(80), fa.decode_layout(128), fa.decode_layout(64)]
    assert "X(80, 80)" in text


# --------------------------------------------------------------------------
# the schedule against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dh", DIMS)
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("lq", [1, 2])
@pytest.mark.parametrize("causal,window", MASKS)
def test_split_model_matches_pallas(dh, group, lq, causal, window):
    """Every head dim, GQA group, Lq of 1 and 2 and mask, at Lk = 1, 2, 31,
    32 and 33, under 1, 2, 3 and Lk splits: the model within 2e-3 of the
    Pallas kernel (at Lk = 33) and within 1e-5 of the plain version."""
    for lk in LKS:
        q, k, v = _case(2, group, lq, lk, dh, seed=sum(_dims(dh)) + 10 * group + 100 * lq + lk)
        plain = _plain(q, k, v, causal, window)
        pallas = _pallas(q, k, v, causal, window) if lk == LKS[-1] else None
        if pallas is not None:
            np.testing.assert_allclose(plain, pallas, rtol=2e-3, atol=2e-3)
        for n, chunk in sorted({fa.split_chunk(lk, s) for s in (1, 2, 3, lk)}):
            got = _model(q, k, v, causal, window, n, chunk)
            np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5,
                                       err_msg=f"lk={lk} splits={n} chunk={chunk}")
            if pallas is not None:
                np.testing.assert_allclose(got, pallas, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dh", DIMS)
@pytest.mark.parametrize("causal,window", MASKS)
def test_split_model_under_every_split_count(dh, causal, window):
    """Lk = 33 under every split count from 1 to 33 (each split then holds
    one key at the end), group 2 and Lq = 2."""
    lk = 33
    q, k, v = _case(1, 2, 2, lk, dh, seed=7 * sum(_dims(dh)))
    plain = _plain(q, k, v, causal, window)
    for n, chunk in _split_counts(lk, lk):
        np.testing.assert_allclose(_model(q, k, v, causal, window, n, chunk), plain,
                                   rtol=1e-5, atol=1e-5, err_msg=f"splits={n}")


@pytest.mark.parametrize("dh", DIMS)
def test_split_model_over_a_long_cache(dh):
    """A few thousand keys under every split count from 1 to the most
    ``decode_splits`` gives at that length (one block, the H100's SMs),
    held to Pallas and to the plain version; the split the wrapper takes
    for qwen3's 32 blocks among them."""
    lk = 2500
    dqk, dv = _dims(dh)
    q, k, v = _case(1, 2, 1, lk, dh, seed=dqk + dv)
    plain = _plain(q, k, v, True, 0)
    np.testing.assert_allclose(plain, _pallas(q, k, v, True, 0), rtol=2e-3, atol=2e-3)
    largest = fa.decode_splits(lk, 1, dqk, H100_SMS)[0]
    assert largest > 1
    counts = _split_counts(lk, largest)
    assert fa.decode_splits(lk, 32, dqk, H100_SMS) in counts
    for n, chunk in counts:
        np.testing.assert_allclose(_model(q, k, v, True, 0, n, chunk), plain, rtol=1e-5,
                                   atol=1e-5, err_msg=f"splits={n}")


@pytest.mark.parametrize("dh", [32, 128])
def test_split_model_zeroes_rows_without_keys(dh):
    """Rows whose keys are all masked come out 0, not NaN: causal with
    more queries than keys (the first query sits before every key); under
    a window of 1 each row sees one key, so every other split and team
    holds none of its keys and must weigh nothing; and no key at all."""
    q, k, v = _case(1, 2, 2, 1, dh, seed=3)
    for n, chunk in [(1, 1)]:
        out = _model(q, k, v, True, 0, n, chunk)
        assert np.isfinite(out).all()
        assert np.array_equal(out[:, :, 0], np.zeros_like(out[:, :, 0]))
        np.testing.assert_allclose(out, _plain(q, k, v, True, 0), rtol=1e-5, atol=1e-5)
    q, k, v = _case(1, 8, 2, 40, dh, seed=4)
    for n, chunk in _split_counts(40, 5):
        out = _model(q, k, v, True, 1, n, chunk)
        np.testing.assert_allclose(out, _plain(q, k, v, True, 1), rtol=1e-5, atol=1e-5)
    q, k, v = _case(1, 2, 1, 0, dh, seed=5)
    out = _model(q, k, v, True, 0, *fa.decode_splits(0, 2, dh, H100_SMS))
    assert np.array_equal(out, np.zeros_like(out))


def test_split_rescale_fault_fails_the_check():
    """The splits folded without their exp(m_s - m) weights (chip_smoke.py's
    fault control) miss the plain version by far more than 2e-3 over a
    long cache, so the check the kernel passes can fail there."""
    lk = 2048
    q, k, v = _case(1, 2, 1, lk, 128, seed=11)
    n, chunk = fa.decode_splits(lk, 2, 128, H100_SMS)
    assert n > 1
    plain = _plain(q, k, v, True, 0)
    bad = _model(q, k, v, True, 0, n, chunk, rescale=False)
    assert not np.allclose(bad, plain, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_model(q, k, v, True, 0, n, chunk), plain, rtol=1e-5, atol=1e-5)


def _ring_case(lk, seed):
    """h2o-danube's ring step: q [1, 32, 1, 120] over 8 kv heads of ``lk``
    slots, read from the [B, buf, Hkv, Dh] ring as the model reads it."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, 32, 1, 120)).astype(np.float32)
    k, v = (np.ascontiguousarray(rng.normal(size=(1, lk, 8, 120)).astype(np.float32)
                                 .transpose(0, 2, 1, 3)) for _ in range(2))
    return q, k, v


def test_split_model_at_the_ring_plan():
    """The ring step at its full 4,096 slots under the plan the wrapper
    takes there (4 rows a block, 16 splits of 256 keys; Dh 120 laid out as
    its 128 instantiation): the model within 2e-3 of the Pallas kernel and
    1e-5 of the plain version; the last split left out of the fold (a last
    block that folds before every split has written) and the splits folded
    without their weights both miss by far more than 2e-3."""
    q, k, v = _ring_case(4096, seed=12)
    r, _, n, chunk = fa.decode_plan(1, 8, 4, 4096, 128, H100_SMS)
    assert (r, n, chunk) == (4, 16, 256)
    plain = _plain(q, k, v, True, 0)
    pallas = _pallas(q, k, v, True, 0)
    np.testing.assert_allclose(plain, pallas, rtol=2e-3, atol=2e-3)
    _, teams, unit = fa.decode_layout(128)
    model = ref.flash_attention_split_ref(*(torch.from_numpy(a) for a in (q, k, v)), True, 0,
                                          n_splits=n, chunk=chunk, teams=teams,
                                          unit=unit).numpy()
    np.testing.assert_allclose(model, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(model, pallas, rtol=2e-3, atol=2e-3)
    for fault in ({"broken": "lost_split"}, {"rescale": False}):
        bad = ref.flash_attention_split_ref(*(torch.from_numpy(a) for a in (q, k, v)), True, 0,
                                            n_splits=n, chunk=chunk, teams=teams, unit=unit,
                                            **fault).numpy()
        assert not np.allclose(bad, pallas, rtol=2e-3, atol=2e-3), fault


@pytest.mark.parametrize("dh", [80, 128])
@pytest.mark.parametrize("causal,window", MASKS)
def test_split_model_unit_rescale_fault_fails(dh, causal, window):
    """zamba2's step over its 64-slot ring (one split; two units a team):
    a team's state left unscaled where a unit raises its max misses Pallas
    by far more than 2e-3 (but for the windowed mask), where the model
    meets it; and keyless rows (more queries than keys under causal) come
    out 0."""
    q, k, v = _case(2, 4, 2, 64, dh, seed=dh + int(causal) + window)
    n, chunk = fa.decode_splits(64, 2 * HKV, dh, H100_SMS)
    assert n == 1
    pallas = _pallas(q, k, v, causal, window)
    np.testing.assert_allclose(_model(q, k, v, causal, window, n, chunk), pallas, rtol=2e-3,
                               atol=2e-3)
    bad = _model(q, k, v, causal, window, n, chunk, broken="no_unit_rescale")
    # under a window of 8 a team holds at most one key a row sees: no
    # unit raises a max it already had, so the fault changes nothing there
    assert np.allclose(bad, pallas, rtol=2e-3, atol=2e-3) == (window > 0)
    q, k, v = _case(1, 2, 3, 2, dh, seed=dh)
    out = _model(q, k, v, True, 0, 1, 2)
    assert np.array_equal(out[:, :, 0], np.zeros_like(out[:, :, 0]))
    np.testing.assert_allclose(out, _plain(q, k, v, True, 0), rtol=1e-5, atol=1e-5)
