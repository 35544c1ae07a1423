"""The bf16 tensor-core forward's schedule, held to the reference on the CPU.

``csrc/flash_attention_sm90.cu`` numbers a kv head's query rows head-major,
cuts them into blocks of 128 rows (two consumer warpgroups) or 64 (one),
streams the key tiles of the block from its first visible key, and lets each
64-row consumer fold the tiles its own rows see into its ``(m, l, O)`` in the
exp2 domain, masking key by key only on edge tiles and rounding P to bf16
before ``P.V``. The CUDA kernel runs only on the card
(``tests/test_torch_gpu.py``); here ``ref.flash_attention_sm90_ref`` takes
the same steps in plain PyTorch and is held to the reference's Pallas kernel
in interpret mode and to the plain version within bf16's ``3e-2``, its
log-sum-exp to ``ref.attention_lse_ref``, in both row forms at every
instantiation's widths; a broken consumer (no rescale, or the next stage's V)
fails that check. A text test reads the instantiations and the form choice
from the source.
"""
import math
import re

import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import _build, ref
from repro_torch.kernels import flash_attention as fa

from _csrc import defined as _defined, returned as _returned

SOURCE = (_build.CSRC / "flash_attention_sm90.cu").read_text()
SMEM_LIMIT = 232448  # shared memory a block may use on sm_90 (227 KB)
TOL = 3e-2  # bf16's tolerance, the reference tests'
HKV = 2
MASKS = [(True, 0), (True, 48), (False, 0)]
# the LM configs' (Dqk, Dv) pairs: hubert and zamba2 (80), h2o-danube (120),
# MLA's prefill and absorbed decode, the smoke MLA's
CONFIG_PAIRS = [(80, 80), (120, 120), (192, 128), (576, 512), (48, 32), (80, 64)]


def _widths():
    """FA90_WIDTHS as the source lists it: (DQK, DV, KEYS, most consumers)."""
    table = SOURCE[SOURCE.index("#define FA90_WIDTHS(X)"):]
    table = table[:table.index("\n\n")]
    return [tuple(int(x) for x in m) for m in
            re.findall(r"X\((\d+),\s*(\d+),\s*(\d+),\s*(\d+)\)", table)]


WIDTHS = _widths()


K_ROWS = _defined(SOURCE, "kRows")


def _pick(dqk, dv):
    """The instantiation the source's pick gives (dqk, dv): the first whose
    Q/K width holds dqk and whose value slice holds dv or is the widest
    (256, cut over grid.y)."""
    for entry in WIDTHS:
        if dqk <= entry[0] and (dv <= entry[1] or entry[1] == 256):
            return entry
    raise ValueError((dqk, dv))


def _form_rows(forms, rows):
    """The rows a block holds, by the source's form_consumers: its consumer
    warpgroups times kRows."""
    return K_ROWS * _returned(SOURCE, "form_consumers", forms=forms, rows=rows, kRows=K_ROWS)


# a pair each instantiation runs at (576's value slice of 256 is MLA's 512 in two)
PAIRS = sorted({(e[0], 512 if e[0] == 576 else e[1]) for e in WIDTHS} | set(CONFIG_PAIRS))


def _case(group, lq, lk, dqk, dv, seed):
    """bf16 inputs from a seed, as float32 numpy arrays of bf16 values."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).bfloat16()
               for s in [(1, HKV * group, lq, dqk), (1, HKV, lk, dqk), (1, HKV, lk, dv)])
    return q, k, v


def _scale(dqk, dv):
    return 1.0 / math.sqrt(192) if (dqk, dv) in ((192, 128), (576, 512)) else None


def _pallas(q, k, v, causal, window, scale):
    """The reference's kernel on the same bf16 values in float32, which
    takes one head dim and the default scale: values narrower than the keys
    are padded with zero columns, and a scale is folded into q."""
    qn, kn, vn = (t.float().numpy() for t in (q, k, v))
    dqk, dv = qn.shape[-1], vn.shape[-1]
    if scale is not None:
        qn = qn * np.float32(scale * math.sqrt(dqk))
    vp = np.pad(vn, [(0, 0)] * 3 + [(0, dqk - dv)])
    return np.asarray(ref_ops.flash_attention(qn, kn, vp, causal=causal, window=window,
                                              block_q=64, block_k=64, interpret=True))[..., :dv]


def _model(q, k, v, causal, window, scale, block_rows, fault=None):
    keys = _pick(q.shape[-1], v.shape[-1])[2]
    return ref.flash_attention_sm90_ref(q, k, v, causal, window, scale, block_rows=block_rows,
                                        keys=keys, fault=fault)


def _forms(dqk, dv):
    """The block rows of the forms an instantiation takes."""
    return (64, 128) if _pick(dqk, dv)[3] == 2 else (64,)


@pytest.mark.parametrize("dqk,dv", PAIRS, ids=lambda p: str(p))
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("causal,window", MASKS)
def test_sm90_model_matches_pallas(dqk, dv, group, causal, window):
    """Every instantiation's widths and the configs' pairs, causal, windowed
    and bidirectional, GQA group 1 and 4, Lq not a multiple of either block
    (150 and 4 x 40 rows: the 128-row form's last block holds a short first
    consumer and an empty second one) and Lk > Lq: the model in each row
    form within 3e-2 of the Pallas kernel and of the plain version, its lse
    the plain one."""
    lq = {1: 150, 4: 40}[group]
    q, k, v = _case(group, lq, lq + 37, dqk, dv, seed=dqk + dv + 7 * group + window)
    scale = _scale(dqk, dv)
    pallas = _pallas(q, k, v, causal, window, scale)
    plain = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal, window, scale)
    np.testing.assert_allclose(plain.numpy(), pallas, rtol=2e-3, atol=2e-3)
    want_lse = ref.attention_lse_ref(q, k, causal, window, scale)
    live = torch.isfinite(want_lse)
    for block_rows in _forms(dqk, dv):
        out, lse = _model(q, k, v, causal, window, scale, block_rows)
        assert out.dtype == torch.bfloat16 and out.shape == (1, HKV * group, lq, dv)
        np.testing.assert_allclose(out.float().numpy(), pallas, rtol=TOL, atol=TOL,
                                   err_msg=f"block_rows={block_rows}")
        np.testing.assert_allclose(out.float().numpy(), plain.numpy(), rtol=TOL, atol=TOL)
        assert torch.equal(torch.isfinite(lse), live)
        err = float((lse[live] - want_lse[live]).abs().max())
        assert err <= 1e-5 * max(1.0, float(want_lse[live].abs().max())), err


@pytest.mark.parametrize("dqk,dv", [(80, 80), (128, 128)], ids=lambda p: str(p))
@pytest.mark.parametrize("lq,lk", [(1, 1), (1, 300), (13, 13), (64, 64), (65, 129), (40, 10)])
def test_sm90_model_around_the_tiles(dqk, dv, lq, lk):
    """A decode step, one row tile exactly, one row past it, and more
    queries than keys (the first rows see no key: 0 and lse +inf), group 4,
    every mask, both forms: within 3e-2 of the plain version."""
    q, k, v = _case(4, lq, lk, dqk, dv, seed=lq + lk + dqk)
    for (causal, window), block_rows in ((m, f) for m in MASKS for f in (64, 128)):
        out, lse = _model(q, k, v, causal, window, None, block_rows)
        plain = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal, window)
        assert torch.isfinite(out.float()).all()
        np.testing.assert_allclose(out.float().numpy(), plain.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=f"causal={causal} window={window} rows={block_rows}")
        want = ref.attention_lse_ref(q, k, causal, window)
        assert torch.equal(torch.isfinite(lse), torch.isfinite(want))


@pytest.mark.parametrize("fault", ["skip_rescale", "next_stage"])
def test_sm90_model_fault_fails_the_check(fault):
    """A consumer that skips its rescale of O, or multiplies P by the next
    stage's V, misses Pallas and the plain version by far more than 3e-2
    over a causal prefill in both forms, so the check the kernel passes can
    fail there; the sound model passes it on the same inputs."""
    q, k, v = _case(1, 300, 300, 128, 128, seed=11)
    pallas = _pallas(q, k, v, True, 0, None)
    for block_rows in (64, 128):
        bad, _ = _model(q, k, v, True, 0, None, block_rows, fault=fault)
        assert not np.allclose(bad.float().numpy(), pallas, rtol=TOL, atol=TOL)
        good, _ = _model(q, k, v, True, 0, None, block_rows)
        np.testing.assert_allclose(good.float().numpy(), pallas, rtol=TOL, atol=TOL)


def test_sm90_widths_and_forms_in_the_source():
    """The instantiations the source lists and its form choice, evaluated
    from the source's own expressions: every config pair runs at one whose
    S takes ceil(Dqk / 16) k-steps and whose P.V runs at N = Dv (MLA's 512
    as two slices of 256), so no product multiplies a zero column; the
    two-consumer form takes a kv head of more than 64 rows where the
    instantiation allows it (all whose value slice is narrower than 256);
    and every instantiation's Q tiles and K/V stages fit 227 KB of shared
    memory in each form it takes, by the source's own count."""
    shape = SOURCE[SOURCE.index("struct Shape {"):]
    shape = shape[:shape.index("\n};")]
    cuh = (_build.CSRC / "sm90.cuh").read_text()
    tile = cuh[cuh.index("struct Tile {"):]
    assert K_ROWS == 64
    assert _defined(SOURCE, "kSmemLimit") == SMEM_LIMIT
    # P.V's wgmma runs at N = DV, the instantiation's value slice
    assert re.search(r"Wgmma<\s*DV\s*>\s*::\s*template\s+rs<\s*1\s*>\s*\(\s*o\s*,", SOURCE)
    for dqk, dv in CONFIG_PAIRS:
        pk, pv, keys, forms = _pick(dqk, dv)
        assert _defined(shape, "kQkSteps", DQK=pk) == -(-dqk // 16), (dqk, dv, pk)
        assert pv == dv or (pv == 256 and dv % pv == 0), (dqk, dv, pv)
    # the two widths whose O takes 128 floats a thread hold one consumer a block
    assert all(e[3] == (1 if e[1] == 256 else 2) for e in WIDTHS)
    assert [_form_rows(f, r) for f, r in ((2, 1), (2, 64), (2, 65), (2, 4096), (1, 4096))] \
        == [64, 64, 128, 128, 64]
    env = {"kRows": K_ROWS, "kMaxStages": _defined(SOURCE, "kMaxStages"),
           "kSmemLimit": SMEM_LIMIT}
    for pk, pv, keys, forms in WIDTHS:
        for nc in range(1, forms + 1):
            e = dict(env, DQK=pk, DV=pv, KEYS=keys, NC=nc)

            def tile_bytes(w, rows):
                return _defined(tile, "kBytes", DH=_returned(SOURCE, "pad_width", w=w), ROWS=rows)

            e.update(TQ_kBytes=tile_bytes(pk, K_ROWS), TK_kBytes=tile_bytes(pk, keys),
                     TV_kBytes=tile_bytes(pv, keys))
            for name in ("kQBytes", "kStageBytes", "kStaticBytes", "kFit", "kStages",
                         "kSmemBytes"):
                e[name] = _defined(shape, name, **e)
            assert 2 <= e["kStages"] <= env["kMaxStages"], (pk, pv, nc, e["kStages"])
            assert e["kSmemBytes"] + e["kStaticBytes"] <= SMEM_LIMIT, (pk, pv, nc, e)
