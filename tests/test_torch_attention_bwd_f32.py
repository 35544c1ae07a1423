"""The float32 attention backward's schedule, held to the reference on the CPU.

``csrc/flash_attention_bwd.cu`` takes each row's log-sum-exp from the
float32 tile route of the forward (log2 domain), sums ``delta =
rowsum(dO o O)`` in a first kernel, then computes dK, dV and each key
tile's part of dQ per block of 64 keys over the query tiles that see them
(S and dP once a pair), and sums the parts of dQ in key-tile order. The
CUDA kernels
run only on the card (``tests/test_torch_gpu.py``); here
``ref.flash_attention_bwd_simt_ref`` takes the same steps in plain PyTorch
and is held to ``jax.vjp`` of the reference's ``kernels/ref.py::
flash_attention_ref`` within ``1e-5`` of the gradient's scale, as
``tests/test_torch_attention_bwd.py`` holds the plain twin, at every
instantiation's width pair, with the forward's output and lse from the tile
route's model; its fault (a row statistic one row off) fails that check.
The tile model's lse is held to the plain one, and the source's tiles,
fragments, stages and shared memory are evaluated from its own expressions.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as fa

from _csrc import defined as _defined

SOURCE = (_build.CSRC / "flash_attention_bwd.cu").read_text()
SMEM_LIMIT = 232448  # shared memory a block may use on sm_90 (227 KB)
RTOL = 1e-5  # tests/test_torch_attention_bwd.py's tolerance against jax.vjp
# (b, h, hkv, lq, lk, dqk, dv, causal, window): every instantiation's width
# pair and the configs' 80, 120 and (48, 32) inside them; causal, windowed
# and bidirectional; groups 1, 2 and 4; ragged tiles on both sides (Lq !=
# Lk); rows that see no key (Lq > Lk, causal)
CASES = [(1, 4, 1, 100, 100, 32, 32, True, 0), (2, 2, 2, 70, 70, 64, 64, False, 0),
         (1, 2, 2, 130, 130, 128, 128, True, 40), (1, 4, 4, 80, 80, 192, 128, True, 0),
         (1, 4, 4, 70, 150, 192, 128, False, 0), (1, 8, 2, 40, 10, 48, 32, True, 0),
         (1, 4, 1, 33, 129, 80, 80, True, 0), (1, 2, 1, 65, 200, 120, 120, True, 48)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(c):
    return "x".join(map(str, c[:7])) + ("-causal" if c[7] else "-bidir") + (
        f"-w{c[8]}" if c[8] else "")


def _inputs(case, seed=0):
    b, h, hkv, lq, lk, dqk, dv, _, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            [(b, h, lq, dqk), (b, hkv, lk, dqk), (b, hkv, lk, dv), (b, h, lq, dv)]]


def _forward(q, k, v, causal, window):
    """The tile route's output and lse, as FlashAttentionFn saves them."""
    bm, bn = fa.tile_shape(q.shape[-1], "large")
    return ref.flash_attention_tile_ref(q, k, v, causal, window, bm=bm, bn=bn, with_lse=True)


def _model(case, fault=None):
    """``(jax.vjp's gradients, the schedule model's)`` of a case. The
    reference's softmax has no gradient at a row that sees no key (its
    vjp is NaN there), which under a causal mask with Lq > Lk are the first
    Lq - Lk rows: the reference takes the other rows (their positions
    unchanged), and those rows' dQ is 0 and add nothing to dK and dV."""
    causal, window = case[7], case[8]
    q, k, v, dout = _inputs(case)
    lq, lk = q.shape[2], k.shape[2]
    blind = lq - lk if causal and lq > lk else 0
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention_ref(a, b, c, causal, window),
                     jnp.asarray(q[:, :, blind:]), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(w) for w in vjp(jnp.asarray(dout[:, :, blind:]))]
    want[0] = np.concatenate([np.zeros_like(q[:, :, :blind]), want[0]], axis=2)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    out, lse = _forward(tq, tk, tv, causal, window)
    keys, rows = fa.bwd_tiles(q.shape[-1])
    got = ref.flash_attention_bwd_simt_ref(tq, tk, tv, out, tdo, lse, causal, window,
                                           keys=keys, rows=rows, fault=fault)
    return want, got


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_simt_model_matches_jax_vjp(case):
    want, got = _model(case)
    for name, a, w in zip("qkv", got, want):
        assert a.shape == w.shape and a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), w, rtol=RTOL, atol=RTOL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("case", [CASES[2], CASES[3]], ids=_ids)
def test_simt_model_fault_fails_the_check(case):
    """Each row reading the next row's lse moves every gradient far past
    the tolerance the model passes."""
    want, got = _model(case, fault="lse_row")
    for name, a, w in zip("qkv", got, want):
        assert not np.allclose(a.numpy(), w, rtol=RTOL, atol=RTOL * np.abs(w).max()), name


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_tile_model_lse_matches_plain(case):
    """The tile route's lse (log2 domain, +inf for a row with no key)
    against ``ref.attention_lse_ref``; its output the same bits as without
    it."""
    causal, window = case[7], case[8]
    q, k, v, _ = map(torch.from_numpy, _inputs(case))
    out, lse = _forward(q, k, v, causal, window)
    bm, bn = fa.tile_shape(q.shape[-1], "large")
    assert torch.equal(out, ref.flash_attention_tile_ref(q, k, v, causal, window, bm=bm, bn=bn))
    want = ref.attention_lse_ref(q, k, causal, window)
    assert lse.shape == want.shape and lse.dtype == torch.float32
    live = torch.isfinite(want)
    assert torch.equal(torch.isfinite(lse), live) and bool((lse[~live] == float("inf")).all())
    assert bool(live.any())
    err = float((lse[live] - want[live]).abs().max())
    assert err <= RTOL * max(1.0, float(want[live].abs().max())), err


def test_tiles_stages_and_shared_memory_in_the_source():
    """The instantiations, the tiles each kernel holds and streams, the
    per-thread fragments and the cp.async stages, evaluated from the
    source's own expressions: bwd_tiles gives the tiles the source builds,
    the thread grid covers them (4 keys against 4 query rows up to 128, 2
    at 192), and the block of every instantiation fits 227 KB of shared
    memory by the source's own count (230,400 bytes at 128)."""
    table = SOURCE[SOURCE.index("#define REPRO_FA_BWD_WIDTHS(X)"):]
    table = table[:table.index("\n\n")]
    widths = [tuple(int(x) for x in m) for m in re.findall(r"X\((\d+),\s*(\d+)\)", table)]
    assert widths == [(32, 32), (64, 64), (128, 128), (192, 128)]
    shape = SOURCE[SOURCE.index("struct Shape {"):]
    shape = shape[:shape.index("\n};")]
    env = {name: _defined(SOURCE, name) for name in ("kThreads", "kGroups", "kR", "kStages")}
    assert env == {"kThreads": 256, "kGroups": 16, "kR": 4, "kStages": 2}
    assert env["kGroups"] ** 2 == env["kThreads"]
    bytes_at = {}
    for dk, dv in widths:
        e = dict(env, DK=dk, DV=dv)
        for name in ("R", "C", "kA", "kB", "kDK", "kDV", "kWK", "kWV", "kSmemFloats",
                     "kSmemBytes"):
            e[name] = _defined(shape, name, **e)
        assert fa.bwd_tiles(dk) == (e["kA"], e["kB"]), (dk, dv)
        assert (e["R"], e["C"]) == (4, 4 if dk <= 128 else 2)
        assert e["kDK"] * env["kGroups"] == dk and e["kDV"] * env["kGroups"] == dv
        assert e["kDK"] % e["kWK"] == 0 and e["kDV"] % e["kWV"] == 0
        assert e["kSmemBytes"] <= SMEM_LIMIT, (dk, dv, e)
        bytes_at[(dk, dv)] = e["kSmemBytes"]
    assert bytes_at[(128, 128)] == 230400
    # the dQ parts' scratch counts key tiles of kA keys
    assert re.search(r"key_tiles = \(lk \+ kR \* kGroups - 1\) / \(kR \* kGroups\)", SOURCE)
    # a width that is no multiple of 4 takes no instantiation (16-byte rows)
    assert re.search(r"dqk % 4 != 0 \|\| dv % 4 != 0", SOURCE)
