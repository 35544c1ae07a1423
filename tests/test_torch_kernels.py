"""The port's kernel modules against the reference's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold those to the reference's ``ops.shuffle_reduce`` /
``ops.edge_stream`` / ``ops.flash_attention`` / ``ops.moe_gather``
(Pallas, interpret mode) at the shapes of ``tests/test_kernels.py``.
Exact for min, max, int32 and the gather; float32 ``+`` with
``rtol=1e-6, atol=1e-6`` (the two sum in different orders); attention
within the reference tests' own ``2e-3`` (float32, where the port is
also held to ``1e-5``) and ``3e-2`` (bfloat16). The CUDA
kernels themselves are held to these plain versions in
``tests/test_torch_gpu.py``.
"""
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import _build
from repro_torch.kernels import edge_stream as es
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_dispatch as md
from repro_torch.kernels import ref
from repro_torch.kernels import shuffle_reduce as sr

SR_SHAPES = [(64, 16), (1000, 300), (4096, 512), (513, 1024), (7, 5)]
ES_SHAPES = [(128, 32), (3000, 400), (5000, 123)]
FA_SHAPES = [(1, 2, 2, 64, 64, 32), (2, 4, 2, 128, 128, 64), (1, 4, 1, 1, 256, 64),
             (1, 2, 2, 100, 100, 32)]
MOE_SHAPES = [(8, 256, 64, 128), (4, 128, 32, 128), (16, 512, 128, 128)]


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


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,hkv,lq,lk,dh", FA_SHAPES)
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 48)])
def test_flash_attention_matches_pallas(b, h, hkv, lq, lk, dh, causal, window):
    rng = np.random.default_rng(b * 1000 + lq + lk + dh)
    q = rng.normal(size=(b, h, lq, dh)).astype(np.float32)
    k = rng.normal(size=(b, hkv, lk, dh)).astype(np.float32)
    v = rng.normal(size=(b, hkv, lk, dh)).astype(np.float32)
    want = np.asarray(ref_ops.flash_attention(q, k, v, causal=causal, window=window,
                                              block_q=64, block_k=64, interpret=True))
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             causal=causal, window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_flash_attention_bf16_matches_pallas():
    rng = np.random.default_rng(21)
    q, k, v = (rng.normal(size=(1, 2, 128, 64)).astype(np.float32) for _ in range(3))
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(ref_ops.flash_attention(*bf, causal=True, interpret=True), np.float32)
    got = fa.flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2, atol=3e-2)


def test_flash_attention_reads_the_cache_layout_in_place():
    """[B, L, H, Dh] activations and a [B, buf, Hkv, Dh] cache prefix,
    viewed as [B, H, L, Dh] by a transpose, give what the contiguous
    tensors give; the output keeps q's layout."""
    rng = np.random.default_rng(22)
    q = torch.from_numpy(rng.normal(size=(2, 1, 8, 32)).astype(np.float32))
    cache = torch.from_numpy(rng.normal(size=(2, 12, 2, 32)).astype(np.float32))
    kv = cache[:, :5].transpose(1, 2)
    got = fa.flash_attention(q.transpose(1, 2), kv, kv)
    want = fa.flash_attention(q.transpose(1, 2).contiguous(), kv.contiguous(), kv.contiguous())
    assert torch.equal(got, want)
    assert got.transpose(1, 2).is_contiguous()


def test_flash_attention_fully_masked_rows_are_zero():
    """Causal with more queries than keys: the first rows see no key and
    come out 0 through the 1e-30 clamp, not NaN."""
    rng = np.random.default_rng(23)
    q = torch.from_numpy(rng.normal(size=(1, 2, 6, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 1, 3, 32)).astype(np.float32))
    out = fa.flash_attention(q, k, k, causal=True)
    assert torch.isfinite(out).all()
    assert torch.equal(out[:, :, :3], torch.zeros_like(out[:, :, :3]))
    assert (out[:, :, 3:].abs().sum(-1) > 0).all()


def test_flash_attention_rejects_bad_shapes():
    q = torch.zeros(1, 3, 4, 32)
    with pytest.raises(ValueError, match="do not fit"):
        fa.flash_attention(q, torch.zeros(1, 2, 4, 32), torch.zeros(1, 2, 4, 32))
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, q, q, window=-1)
    with pytest.raises(ValueError, match="Lk, Dv"):  # values over other keys than k's
        fa.flash_attention(q, q, torch.zeros(1, 3, 5, 32))
    with pytest.raises(ValueError, match="do not fit"):  # values wider than the keys
        fa.flash_attention(q, q, torch.zeros(1, 3, 4, 64))
    assert fa.flash_attention(q, q, q[..., :16]).shape == (1, 3, 4, 16)  # Dv < Dqk (MLA)


def _stand_in(device_type: str, dtype: torch.dtype, lq: int = 64):
    """What the route reads of q, and nothing else: no card is needed."""
    return types.SimpleNamespace(device=types.SimpleNamespace(type=device_type), dtype=dtype,
                                 shape=(1, 8, lq, 32))


@pytest.mark.parametrize("device_type,dtype,route", [
    ("cuda", torch.bfloat16, "sm90"), ("cuda", torch.float32, "cuda_core"),
    ("cpu", torch.bfloat16, "plain"), ("cpu", torch.float32, "plain")])
def test_flash_attention_route_follows_dtype_and_device(device_type, dtype, route):
    assert fa._route(_stand_in(device_type, dtype)) == route


def test_flash_attention_route_rejects_what_no_kernel_takes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._route(_stand_in("cuda", torch.float16))
    with pytest.raises(ValueError, match="device type"):
        fa._route(_stand_in("mps", torch.float32))


@pytest.mark.parametrize("route", ["sm90", "cuda_core"])
def test_flash_attention_routes_have_built_sources(route):
    source, entry = fa.KERNELS[route]
    assert source in _build.SOURCES
    assert f'extern "C" int {entry}(' in (_build.CSRC / f"{source}.cu").read_text()


@pytest.mark.parametrize("group,lq,route", [
    (2, 1, "decode"), (8, 1, "decode"), (48, 1, "decode"), (1, 1, "decode"),
    (2, 2, "decode"), (8, 2, "decode"), (2, 8, "decode"), (1, 16, "decode"),
    (2, 16, "cuda_core"), (8, 4, "cuda_core"), (1, 17, "cuda_core"), (4, 64, "cuda_core")])
def test_flash_attention_float32_route_follows_the_rows(group, lq, route):
    """float32 on the card takes the decode route at Lq = 1 whatever the
    group (qwen3-0.6b's 2, Kimi-K2's 8, granite-20b's 48) and whenever
    group x Lq is at most DECODE_MAX_ROWS; qwen3's 16-token forward (32
    rows) and anything larger take the tile route."""
    assert (group * lq <= fa.DECODE_MAX_ROWS or lq == 1) == (route == "decode")
    assert fa._route(_stand_in("cuda", torch.float32, lq), group) == route


@pytest.mark.parametrize("group,lq", [(1, 1), (8, 1), (48, 1), (2, 2), (2, 16), (4, 64)])
def test_flash_attention_decode_route_takes_only_float32_on_the_card(group, lq):
    """bfloat16 never takes the decode route (it has the tensor-core
    kernel), and a CPU tensor always takes the plain version."""
    assert fa._route(_stand_in("cuda", torch.bfloat16, lq), group) == "sm90"
    for dtype in (torch.float32, torch.bfloat16):
        assert fa._route(_stand_in("cpu", dtype, lq), group) == "plain"


def test_flash_attention_decode_on_the_cpu_launches_nothing():
    """A decode-shaped call on CPU tensors runs the plain version: no
    counter moves, and the result is the plain version's."""
    rng = np.random.default_rng(24)
    q = torch.from_numpy(rng.normal(size=(2, 16, 1, 128)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 8, 32, 128)).astype(np.float32))
            for _ in range(2))
    before = (fa.LAUNCHES, fa.SM90_LAUNCHES, fa.DECODE_LAUNCHES)
    got = fa.flash_attention(q, k, v)
    assert (fa.LAUNCHES, fa.SM90_LAUNCHES, fa.DECODE_LAUNCHES) == before
    assert torch.equal(got, ref.flash_attention_ref(q, k, v))


def test_flash_attention_launch_refuses_a_route_of_another_dtype():
    """Each route's kernel takes one dtype: asked to run bfloat16 on a
    float32 route, or float32 on the tensor-core route, the launcher
    raises before it reaches a kernel."""
    x = torch.zeros(1, 2, 1, 32)
    for route, dtype in (("decode", torch.bfloat16), ("cuda_core", torch.bfloat16),
                         ("sm90", torch.float32)):
        t = x.to(dtype)
        with pytest.raises(TypeError, match="does not take"):
            fa._launch(route, t, t, t, True, 0)


def test_flash_attention_decode_route_has_its_entry_point():
    """The decode route is a second entry point of the float32 source,
    which _build compiles; no sum of its kernel uses atomics: its one
    atomic is the count by which a row tile's last block learns that every
    split has written its partial, and that block folds them in split
    order."""
    source, entry = fa.KERNELS["decode"]
    assert source == fa.KERNELS["cuda_core"][0] and source in _build.SOURCES
    text = (_build.CSRC / f"{source}.cu").read_text()
    assert f'extern "C" int {entry}(' in text
    assert "flash_decode_kernel" in text and "flash_decode_combine_kernel" not in text
    decode = text[text.index("// decode route"):]
    atomics = re.findall(r"atomic[A-Z]\w*|\batom\.[\w.]+|\bred\.[\w.]+", decode)
    assert atomics == ["atom.acq_rel.gpu.global.add.s32"], atomics
    assert '"l"(counters + tile_id)' in decode


def test_flash_attention_sm90_source_keeps_its_contract():
    """No atomics on results: each output row is written by the one block
    that reduced all of its keys, so two calls give the same bits (the
    no-split design the card's tests check by calling twice)."""
    text = (_build.CSRC / "flash_attention_sm90.cu").read_text()
    assert not re.search(r"atomic[A-Z]|\batom\.|\bred\.", text)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_bwd_routes_by_dtype_to_built_sources(dtype):
    """The backward's source follows the dtype: bfloat16 the tensor-core
    source, float32 the CUDA-core one; each is built and has its launch and
    widths entries."""
    source = fa.BWD_SOURCES[dtype]
    assert source == ("flash_attention_bwd_sm90" if dtype == torch.bfloat16
                      else "flash_attention_bwd")
    assert source in _build.SOURCES
    text = (_build.CSRC / f"{source}.cu").read_text()
    assert f'extern "C" int repro_{source}(' in text
    assert f'extern "C" int {fa.WIDTHS[source]}(' in text


def test_flash_attention_bwd_sources_keep_their_contract():
    """No atomics in either backward: the group is summed inside a block
    and no key is split, so two calls give the same bits. The tensor-core
    source multiplies through wgmma on tiles that arrive by TMA and takes
    the forward's lse; the CUDA-core source is float32 only."""
    sm90 = (_build.CSRC / "flash_attention_bwd_sm90.cu").read_text()
    f32 = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    for text in (sm90, f32):
        assert not re.search(r"atomic[A-Z]|\batom\.|\bred\.", text)
    assert "Wgmma<" in sm90 and "tma_load_4d(" in sm90 and "const float* lse" in sm90
    assert "__nv_bfloat16" not in f32 and "dtype" not in f32


def test_flash_attention_lse_only_from_the_tensor_core_route():
    """Only the routes whose kernel writes the log-sum-exp the backward
    takes give it: the bf16 tensor-core route and the float32 tile route.
    The float32 decode route asked for it raises before it reaches a
    kernel."""
    assert fa.LSE_ROUTES == ("sm90", "cuda_core")
    t = torch.zeros(1, 2, 4, 32)
    with pytest.raises(ValueError, match="log-sum-exp"):
        fa._launch("decode", t, t, t, True, 0, with_lse=True)


def test_flash_attention_alignment_is_counted_in_bytes():
    """The kernels copy 16 bytes at a time: a row stride of 36 elements is
    aligned in float32 (144 bytes) but not in bfloat16 (72 bytes); the
    [B, buf, Hkv, Dh] cache prefix is read in place; a broadcast (zero)
    stride, which no tensor map takes, is copied."""
    base = torch.zeros(2, 3, 4, 36)
    f32 = base[..., :32]
    assert fa._aligned(f32) is f32
    bf = base.bfloat16()[..., :32]
    fixed = fa._aligned(bf)
    assert fixed is not bf and fixed.is_contiguous() and torch.equal(fixed, bf)
    cache = torch.zeros(2, 12, 8, 128, dtype=torch.bfloat16)[:, :5].transpose(1, 2)
    assert fa._aligned(cache) is cache
    expanded = torch.zeros(1, 2, 4, 32).expand(3, 2, 4, 32)  # a zero stride: copied
    assert fa._aligned(expanded) is not expanded


# --------------------------------------------------------------------------
# moe dispatch
# --------------------------------------------------------------------------


def _moe_case(e, c, d, bc, seed):
    """The reference test's case: block-aligned groups of random sizes."""
    rng = np.random.default_rng(seed)
    sizes = np.minimum(rng.multinomial(e * c // 2, np.ones(e) / e), c).astype(np.int32)
    aligned = ((sizes + bc - 1) // bc) * bc
    offs = np.zeros(e, np.int32)
    offs[1:] = np.cumsum(aligned)[:-1]
    tbuf = int(offs[-1] + aligned[-1])
    tok = rng.normal(size=(tbuf, d)).astype(np.float32)
    return tok, offs, sizes


@pytest.mark.parametrize("e,c,d,bc", MOE_SHAPES)
def test_moe_gather_matches_pallas(e, c, d, bc):
    tok, offs, sizes = _moe_case(e, c, d, bc, seed=e + c + d)
    want = np.asarray(ref_ops.moe_gather(tok, offs, sizes, c, interpret=True))
    got = md.moe_gather(torch.from_numpy(tok), torch.from_numpy(offs),
                        torch.from_numpy(sizes), c)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("e,c,d,bc", MOE_SHAPES)
def test_moe_gather_fused_rows_matches_gather_then_call(e, c, d, bc):
    """The MoE layer's form: groups of tokens read through a row map
    (unaligned offsets) equal gathering the rows first."""
    rng = np.random.default_rng(e * c)
    g, t, r = 3, 50, 4 * e
    x = torch.from_numpy(rng.normal(size=(g, t, d)).astype(np.float32))
    rows = torch.from_numpy(rng.integers(0, t, (g, r)).astype(np.int32))
    sizes = torch.from_numpy(rng.integers(0, c + 1, (g, e)).astype(np.int32))
    offs = torch.from_numpy(rng.integers(0, r, (g, e)).astype(np.int32))
    got = md.moe_gather(x, offs, sizes, c, rows=rows)
    for gi in range(g):
        want = md.moe_gather(x[gi][rows[gi].long()], offs[gi], sizes[gi], c)
        assert torch.equal(got[gi], want)
    # the Pallas kernel needs block-aligned offsets; its oracle takes any
    want = np.asarray(jax_ref.moe_gather_ref(x[1][rows[1].long()].numpy(), offs[1].numpy(),
                                             sizes[1].numpy(), c))
    np.testing.assert_array_equal(got[1].numpy(), want)


def test_moe_gather_clamps_offsets_and_rows():
    x = torch.arange(6 * 4, dtype=torch.float32).reshape(1, 6, 4)
    rows = torch.tensor([[5, 0, 9, -2]], dtype=torch.int32)
    offs = torch.tensor([[-3, 2, 7]], dtype=torch.int32)
    sizes = torch.tensor([[2, 2, 1]], dtype=torch.int32)
    got = md.moe_gather(x, offs, sizes, 2, rows=rows)
    # slots clamp into [0, 4): expert 0 reads slots 0, 0; expert 1 slots 2, 3;
    # expert 2 slot 3; rows clamp into [0, 6): 9 -> 5, -2 -> 0
    want_rows = [[5, 5], [5, 0], [0, None]]
    for e, rr in enumerate(want_rows):
        for c, row in enumerate(rr):
            want = torch.zeros(4) if row is None else x[0, row]
            assert torch.equal(got[0, e, c], want), (e, c)


def test_new_kernels_never_launch_on_the_cpu():
    before = (fa.LAUNCHES, fa.SM90_LAUNCHES, md.LAUNCHES)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.ones(1, 1, 2, 32, dtype=dtype)
        fa.flash_attention(x, x, x)
    md.moe_gather(torch.ones(4, 8), torch.zeros(2, dtype=torch.int32),
                  torch.ones(2, dtype=torch.int32), 2)
    assert (fa.LAUNCHES, fa.SM90_LAUNCHES, md.LAUNCHES) == before
