"""The port's kernel modules against the reference's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold those to the reference's ``ops.shuffle_reduce`` /
``ops.edge_stream`` (Pallas, interpret mode) at the shapes of
``tests/test_kernels.py``. Exact for min, max and int32; float32 ``+``
with ``rtol=1e-6, atol=1e-6`` (the two sum in different orders). The CUDA
kernels themselves are held to these plain versions in
``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import edge_stream as es
from repro_torch.kernels import ref
from repro_torch.kernels import shuffle_reduce as sr

SR_SHAPES = [(64, 16), (1000, 300), (4096, 512), (513, 1024), (7, 5)]
ES_SHAPES = [(128, 32), (3000, 400), (5000, 123)]


def _assert_matches(got: torch.Tensor, want, op: str):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.float32 and op == "+":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,v", SR_SHAPES)
@pytest.mark.parametrize("op", ["+", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_shuffle_reduce_matches_pallas(n, v, op, dtype):
    rng = np.random.default_rng(n * 7 + v)
    idx = rng.integers(0, v, n).astype(np.int32)
    vals = rng.integers(-50, 50, n).astype(dtype)
    want = ref_ops.shuffle_reduce(vals, idx, v, op, interpret=True)
    got = sr.shuffle_reduce(torch.from_numpy(vals), torch.from_numpy(idx), v, op)
    _assert_matches(got, want, op)


@pytest.mark.parametrize("op", ["+", "min", "max"])
def test_shuffle_reduce_float_values_and_dropped_indices(op):
    """Non-integer floats, and indices past n_out that are dropped."""
    rng = np.random.default_rng(3)
    n, v = 2000, 300
    idx = rng.integers(0, v + 40, n).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)
    want = jax_ref.shuffle_reduce_ref(vals, idx, v, op)
    got = sr.shuffle_reduce(torch.from_numpy(vals), torch.from_numpy(idx), v, op)
    _assert_matches(got, want, op)


def test_shuffle_reduce_empty_bins_hold_identity():
    idx = torch.tensor([2, 2, 2], dtype=torch.int32)
    out = sr.shuffle_reduce(torch.tensor([1.0, 2.0, 3.0]), idx, 5, "min")
    assert out[2] == 1.0 and torch.isinf(out[0]) and torch.isinf(out[4])
    out = sr.shuffle_reduce(torch.tensor([4, 5], dtype=torch.int32),
                            torch.tensor([0, 0], dtype=torch.int32), 3, "max")
    assert out.tolist() == [5, torch.iinfo(torch.int32).min, torch.iinfo(torch.int32).min]


@pytest.mark.parametrize("op", ["+", "min", "max"])
def test_sorted_form_matches_unsorted(op):
    """shuffle_reduce_sorted over (perm, offsets) from route() equals the
    unsorted wrapper, including a broadcast (stride-0) index."""
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, 77, 900).astype(np.int32))
    vals = torch.from_numpy(rng.integers(-9, 9, 900).astype(np.int32))
    perm, offsets = sr.route(idx, 77)
    got = sr.shuffle_reduce_sorted(vals[perm], offsets, 77, op)
    assert torch.equal(got, sr.shuffle_reduce(vals, idx, 77, op))
    one = torch.tensor(4, dtype=torch.int32).expand(900)
    perm, offsets = sr.route(one, 77)
    assert perm is None
    got = sr.shuffle_reduce_sorted(vals, offsets, 77, op)
    assert torch.equal(got, ref.shuffle_reduce_ref(vals, one.contiguous(), 77, op))


@pytest.mark.parametrize("e,v", ES_SHAPES)
@pytest.mark.parametrize("apply_op", ["add", "mul", "src"])
@pytest.mark.parametrize("reduce_op", ["+", "min", "max"])
def test_edge_stream_matches_pallas(e, v, apply_op, reduce_op):
    rng = np.random.default_rng(e + v)
    sv = rng.normal(size=e).astype(np.float32)
    w = rng.normal(size=e).astype(np.float32)
    dst = rng.integers(0, v, e).astype(np.int32)
    act = rng.random(e) < 0.4
    want = ref_ops.edge_stream(sv, w, dst, act, v, apply_op, reduce_op, interpret=True)
    got = es.edge_stream(torch.from_numpy(sv), torch.from_numpy(w), torch.from_numpy(dst),
                         torch.from_numpy(act), v, apply_op, reduce_op)
    _assert_matches(got, want, reduce_op)


@pytest.mark.parametrize("apply_op", ["add", "mul", "src"])
@pytest.mark.parametrize("reduce_op", ["+", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_fused_gather_matches_pregathered(apply_op, reduce_op, dtype):
    """The engine's fused-gather form (vertex operand + mask, dst-sorted
    edges, weights by edge id) equals gathering first and calling the
    reference-shaped wrapper."""
    rng = np.random.default_rng(11)
    n_v, n_e = 150, 2000
    src = rng.integers(0, n_v, n_e).astype(np.int32)
    dst = rng.integers(0, n_v, n_e).astype(np.int32)
    vval = torch.from_numpy(rng.integers(-20, 20, n_v).astype(dtype))
    vact = torch.from_numpy(rng.random(n_v) < 0.5)
    w = torch.from_numpy(rng.integers(1, 9, n_e).astype(dtype))
    perm = np.argsort(dst, kind="stable").astype(np.int32)
    offsets = sr.bin_offsets(torch.from_numpy(dst[perm]), n_v)
    src_s, eid_s = torch.from_numpy(src[perm]), torch.from_numpy(perm)
    got = es.edge_stream_gather(vval, vact, src_s, eid_s, w, offsets, apply_op, reduce_op)
    s = torch.from_numpy(src)
    want = es.edge_stream(vval[s], w, torch.from_numpy(dst), vact[s], n_v, apply_op,
                          reduce_op)
    assert torch.equal(got, want)
    # the same against the reference's Pallas kernel on the gathered stream
    ref_out = ref_ops.edge_stream(vval[s].numpy(), w.numpy(), dst, vact[s].numpy(), n_v,
                                  apply_op, reduce_op, interpret=True)
    _assert_matches(got, ref_out, reduce_op)


def _overrun_case():
    """A sorted stream of 40 int32 values and offsets that run past its end
    (and below 0), with the offsets they clamp to."""
    vals = torch.arange(40, dtype=torch.int32) - 7
    bad = torch.tensor([-5, 3, 10, 10, 38, 55, 90], dtype=torch.int32)
    return vals, bad, bad.clamp(0, 40)


@pytest.mark.parametrize("op", ["+", "min", "max"])
def test_offsets_past_the_stream_are_clamped(op):
    vals, bad, good = _overrun_case()
    got = sr.shuffle_reduce_sorted(vals, bad, 6, op)
    assert torch.equal(got, sr.shuffle_reduce_sorted(vals, good, 6, op))
    empty = ref.identity(op, torch.int32)
    assert got[2].item() == got[5].item() == empty  # [10, 10) and [55, 90) -> [40, 40)
    assert got[4].item() == {"+": 31 + 32, "min": 31, "max": 32}[op]  # [38, 55) -> [38, 40)


def test_wrappers_reject_bad_arguments():
    with pytest.raises(ValueError, match="op"):
        sr.shuffle_reduce_sorted(torch.zeros(3), torch.zeros(2, dtype=torch.int32), 1, "*")
    with pytest.raises(ValueError, match="offsets"):
        sr.shuffle_reduce_sorted(torch.zeros(3), torch.zeros(5, dtype=torch.int32), 1, "+")
    off = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs eid_s"):
        es.edge_stream_gather(torch.zeros(2), torch.ones(2, dtype=torch.bool),
                              torch.zeros(0, dtype=torch.int32), None, None, off, "add", "+")
    with pytest.raises(ValueError, match="apply"):
        es.edge_stream_gather(torch.zeros(2), torch.ones(2, dtype=torch.bool),
                              torch.zeros(0, dtype=torch.int32), None, None, off, "max", "+")


def test_cpu_tensors_never_launch():
    before = (sr.LAUNCHES, es.LAUNCHES)
    sr.shuffle_reduce(torch.ones(4), torch.zeros(4, dtype=torch.int32), 2, "+")
    es.edge_stream(torch.ones(4), torch.ones(4), torch.zeros(4, dtype=torch.int32),
                   torch.ones(4, dtype=torch.bool), 2, "add", "+")
    assert (sr.LAUNCHES, es.LAUNCHES) == before
