"""The hand-written CUDA kernels and the port's main path on the card.

Every test here is marked ``gpu`` and skips without a CUDA device: a CUDA
kernel has no CPU mode. The file imports only ``torch``, numpy and the
port, so it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel is held to its plain PyTorch version on the same inputs
(integer-valued for the reductions, so every summation order is exact;
the gather exactly; attention within 2e-3 in float32 and 3e-2 in
bfloat16, the reference tests' tolerances), each program to the same
program on the CPU, and the LM path's decode to its own forward.
Attention takes its route by dtype: float32 the CUDA-core kernel,
bfloat16 the tensor-core (sm90) kernel, which multiplies bf16 operands
(P rounded to bf16) and so is held to the plain float32 arithmetic within
bf16's 3e-2.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.algorithms import sources
from repro_torch.configs import get_config, smoke_config
from repro_torch.graph import generators
from repro_torch.kernels import edge_stream as es
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_dispatch as md
from repro_torch.kernels import ref
from repro_torch.kernels import shuffle_reduce as sr
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models import moe as moe_mod

SR_SHAPES = [(64, 16), (1000, 300), (4096, 512), (513, 1024), (7, 5)]
ES_SHAPES = [(128, 32), (3000, 400), (5000, 123)]
L = sr.SPLIT_LEN  # edge_stream's chunk length
HUB = 100_003  # edges of the skewed stream's one long bin
LM_BATCH = 4  # the serving CLI's batch: Kimi-K2's decode step dispatches 4 tokens
ALGORITHMS = {
    "bfs": ("BFS_ECP", {"root": 3}),
    "bfs_hybrid": ("BFS_HYBRID", {"root": 3}),
    "pagerank": ("PAGERANK", {"iters": 5}),
    "sssp": ("SSSP", {"root": 3}),
    "ppr": ("PPR", {"source": 3, "max_iters": 8}),
    "cgaw": ("CGAW", {}),
    "wcc": ("WCC", {}),
    "kcore": ("KCORE", {"k": 3}),
}
FLOAT_SUMS = {"pagerank", "ppr", "cgaw"}
FA_SHAPES = [(1, 2, 2, 64, 64, 32), (2, 4, 2, 128, 128, 64), (1, 4, 1, 1, 256, 64),
             (1, 2, 2, 100, 100, 32), (2, 16, 2, 9, 300, 128), (1, 4, 4, 20, 10, 256)]
FA_TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}
SM90_LQ = (1, 63, 65, 100)  # ragged around the kernel's 64-row tiles
SM90_LK = (0, 1, 127, 300)  # ... and its 64-key stages
# max over rows of max |kernel - plain| / rms(plain row), the plain version in
# float32: chip_smoke.py's ROW_REL_TOL, which lies between the sound kernel's
# reading and those of faulty controls (PERF.md)
SM90_ROW_REL_TOL = 5e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["+", "min", "max"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_cuda_shuffle_reduce_matches_plain(cuda, op, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    for n, v in SR_SHAPES:
        idx = torch.randint(0, v + 10, (n,), generator=gen, device=cuda, dtype=torch.int32)
        vals = torch.randint(-50, 50, (n,), generator=gen, device=cuda).to(dtype)
        before = sr.LAUNCHES
        got = sr.shuffle_reduce(vals, idx, v, op)
        assert sr.LAUNCHES == before + 1
        assert torch.equal(got, ref.shuffle_reduce_ref(vals, idx, v, op))


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["+", "min", "max"])
def test_cuda_offsets_past_the_stream_are_clamped(cuda, op):
    vals = torch.arange(40, dtype=torch.int32, device=cuda) - 7
    bad = torch.tensor([-5, 3, 10, 10, 38, 55, 90], dtype=torch.int32, device=cuda)
    good = bad.clamp(0, 40)
    got = sr.shuffle_reduce_sorted(vals, bad, 6, op)
    assert torch.equal(got, ref.segment_reduce_ref(vals, good, op))
    src_s = torch.arange(40, dtype=torch.int32, device=cuda) % 9
    vact = torch.arange(9, device=cuda) % 2 == 0
    vval = torch.arange(9, dtype=torch.int32, device=cuda) * 3
    got = es.edge_stream_gather(vval, vact, src_s, None, None, bad, "src", op)
    assert torch.equal(got, ref.edge_stream_gather_ref(vval, vact, src_s, None, None, good,
                                                       "src", op))
    # a split bin whose end runs past the stream: [L - 5, 4L + 90) clamps to
    # [L - 5, 3L + 40), three chunks; the bins after it clamp to empty
    n = 3 * L + 40
    src_s = torch.arange(n, dtype=torch.int32, device=cuda) % 9
    bad = torch.tensor([-3, L - 5, 4 * L + 90, 5 * L, 5 * L], dtype=torch.int32, device=cuda)
    split = sr.split_bins(bad, n)
    assert split.bins.tolist() == [1] and split.chunks.shape[0] == 3
    got = es.edge_stream_gather(vval, vact, src_s, None, None, bad, "src", op, split)
    assert torch.equal(got, ref.edge_stream_gather_ref(vval, vact, src_s, None, None,
                                                       bad.clamp(0, n), "src", op))


@pytest.mark.gpu
@pytest.mark.parametrize("apply_op", ["add", "mul", "src"])
@pytest.mark.parametrize("reduce_op", ["+", "min", "max"])
def test_cuda_edge_stream_matches_plain(cuda, apply_op, reduce_op):
    gen = torch.Generator(device=cuda).manual_seed(1)
    for e, v in ES_SHAPES:
        sv = torch.randint(-20, 20, (e,), generator=gen, device=cuda).float()
        w = torch.randint(-20, 20, (e,), generator=gen, device=cuda).float()
        dst = torch.randint(0, v, (e,), generator=gen, device=cuda, dtype=torch.int32)
        act = torch.rand(e, generator=gen, device=cuda) < 0.4
        before = es.LAUNCHES
        got = es.edge_stream(sv, w, dst, act, v, apply_op, reduce_op)
        assert es.LAUNCHES == before + 1
        assert torch.equal(got, ref.edge_stream_ref(sv, w, dst, act, v, apply_op, reduce_op))


def _skewed_stream(cuda, dtype, seed: int):
    """A dst-sorted stream with one bin of HUB edges, bins of L-1, L, L+1,
    2L and 2L+1 edges, empty bins and a uniform rest of 0-16 edges a bin;
    float values are integers, so every summation order is exact."""
    rng = np.random.default_rng(seed)
    counts = np.concatenate([[0, HUB, L - 1, L, L + 1, 0, 2 * L, 2 * L + 1, 0],
                             rng.integers(0, 17, 5000)])
    n_v, n_e = 3000, int(counts.sum())
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    src_s = torch.from_numpy(rng.integers(0, n_v, n_e).astype(np.int32))
    eid_s = torch.from_numpy(rng.permutation(n_e).astype(np.int32))
    vact = torch.from_numpy(rng.random(n_v) < 0.6)
    vval = torch.from_numpy(rng.integers(-20, 20, n_v).astype(np.int32)).to(dtype)
    w = torch.from_numpy(rng.integers(-20, 20, n_e).astype(np.int32)).to(dtype)
    return [t.to(cuda) for t in (vval, vact, src_s, eid_s, w, offsets)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("apply_op", ["add", "mul", "src"])
@pytest.mark.parametrize("reduce_op", ["+", "min", "max"])
def test_cuda_edge_stream_splits_long_bins(cuda, dtype, apply_op, reduce_op):
    """A hub bin over 100,000 edges and bins around the chunk length L go
    through the work list (chunks, then the combining pass) and give the
    plain version's answer exactly; one launch is counted per call."""
    vval, vact, src_s, eid_s, w, offsets = _skewed_stream(cuda, dtype, seed=9)
    eid, ww = (None, None) if apply_op == "src" else (eid_s, w)
    split = sr.split_bins(offsets, src_s.shape[0])
    assert split.bins.shape[0] == 4  # HUB, L+1, 2L, 2L+1
    assert split.chunks.shape[0] == -(-HUB // L) + 2 + 2 + 3
    before = es.LAUNCHES
    got = es.edge_stream_gather(vval, vact, src_s, eid, ww, offsets, apply_op, reduce_op, split)
    assert es.LAUNCHES == before + 1
    assert torch.equal(got, ref.edge_stream_gather_ref(vval, vact, src_s, eid, ww, offsets,
                                                       apply_op, reduce_op))
    # without a list the wrapper builds the same one
    assert torch.equal(es.edge_stream_gather(vval, vact, src_s, eid, ww, offsets, apply_op,
                                             reduce_op), got)


@pytest.mark.gpu
@pytest.mark.parametrize("apply_op", ["add", "mul", "src"])
def test_cuda_edge_stream_float_sum_repeats_its_bits(cuda, apply_op):
    """Non-integer floats over the skewed stream: the chunks' partials are
    folded in a fixed order, so two calls give the same bits."""
    _, vact, src_s, eid_s, _, offsets = _skewed_stream(cuda, torch.float32, seed=10)
    gen = torch.Generator(device=cuda).manual_seed(10)
    vval = torch.randn(vact.shape[0], generator=gen, device=cuda)
    w = torch.randn(src_s.shape[0], generator=gen, device=cuda)
    eid, ww = (None, None) if apply_op == "src" else (eid_s, w)
    a = es.edge_stream_gather(vval, vact, src_s, eid, ww, offsets, apply_op, "+")
    b = es.edge_stream_gather(vval, vact, src_s, eid, ww, offsets, apply_op, "+")
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    want = ref.edge_stream_gather_ref(vval, vact, src_s, eid, ww, offsets, apply_op, "+")
    # two summation orders of n_b terms differ by at most 2 (n_b + 5) 2^-24 sum|v|
    upd = ref._apply(apply_op, vval[src_s], None if ww is None else ww[eid])
    ids = ref.bin_ids(offsets).long()
    n_b = torch.bincount(ids, minlength=a.shape[0]).double()
    abs_sum = torch.zeros(a.shape[0], dtype=torch.float64, device=cuda).index_add_(
        0, ids, torch.where(vact[src_s], upd, 0.0).abs().double())
    assert bool(((a.double() - want.double()).abs() <= 2 * (n_b + 5) * 2.0**-24 * abs_sum).all())


@pytest.mark.gpu
@pytest.mark.parametrize("algo", list(ALGORITHMS))
def test_cuda_port_matches_cpu_port(cuda, algo):
    """The same program on the card (hand-written kernels) and on the CPU
    (plain versions) agree, and the kernels were launched (PAGERANK
    commits through ``edge_stream`` alone)."""
    g = generators.power_law(200, 1400, seed=5, weighted=True)
    name, params = ALGORITHMS[algo]
    prog = repro_torch.compile(getattr(sources, name))
    want = prog.bind(g, device="cpu").run(**params)
    before = sr.LAUNCHES + es.LAUNCHES
    got = prog.bind(g).run(**params)
    assert sr.LAUNCHES + es.LAUNCHES > before
    for prop, a in want.properties.items():
        if algo in FLOAT_SUMS and a.dtype == np.float32:
            np.testing.assert_allclose(got.properties[prop], a, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(got.properties[prop], a)
    assert got.host_env == want.host_env
    assert got.stats.kernel_launches == want.stats.kernel_launches


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 48)])
def test_cuda_flash_attention_matches_plain(cuda, dtype, causal, window):
    gen = torch.Generator(device=cuda).manual_seed(2)
    for b, h, hkv, lq, lk, dh in FA_SHAPES:
        q = torch.randn(b, h, lq, dh, generator=gen, device=cuda).to(dtype)
        k = torch.randn(b, hkv, lk, dh, generator=gen, device=cuda).to(dtype)
        v = torch.randn(b, hkv, lk, dh, generator=gen, device=cuda).to(dtype)
        before = (fa.LAUNCHES, fa.SM90_LAUNCHES)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        # bf16 takes the tensor-core kernel, float32 the CUDA-core one
        sm90 = int(dtype == torch.bfloat16)
        assert (fa.LAUNCHES, fa.SM90_LAUNCHES) == (before[0] + 1, before[1] + sm90)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        assert got.dtype == dtype and torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), rtol=FA_TOL[dtype],
                                   atol=FA_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 48)])
def test_cuda_sm90_matches_plain_on_ragged_lengths(cuda, dh, group, causal, window):
    """Every head dim and GQA group over query and key lengths around the
    tile sizes, Lq > Lk included; Lk = 0 gives zeros (the plain version
    cannot reduce over no key)."""
    gen = torch.Generator(device=cuda).manual_seed(dh + group)
    hkv = 2
    for lq in SM90_LQ:
        for lk in SM90_LK:
            q = torch.randn(1, hkv * group, lq, dh, generator=gen, device=cuda).bfloat16()
            k, v = (torch.randn(1, hkv, lk, dh, generator=gen, device=cuda).bfloat16()
                    for _ in range(2))
            before = (fa.LAUNCHES, fa.SM90_LAUNCHES)
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            assert (fa.LAUNCHES, fa.SM90_LAUNCHES) == (before[0] + 1, before[1] + 1)
            want = (ref.flash_attention_ref(q, k, v, causal=causal, window=window) if lk
                    else torch.zeros_like(q))
            torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2,
                                       msg=lambda m: f"lq={lq} lk={lk}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_sm90_long_rows_hold_a_row_relative_limit(cuda, dh, causal):
    """Over ~1,000 keys an output element is ~0.03, as small as the
    absolute 3e-2; each row's error is held to its own rms instead."""
    gen = torch.Generator(device=cuda).manual_seed(8 + dh)
    q = torch.randn(1, 8, 1100, dh, generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn(1, 2, 1100, dh, generator=gen, device=cuda).bfloat16()
            for _ in range(2))
    got = fa.flash_attention(q, k, v, causal=causal).float()
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=causal)
    rms = want.pow(2).mean(dim=-1).sqrt()
    err = float(((got - want).abs().amax(dim=-1) / rms).max())
    assert err <= SM90_ROW_REL_TOL, err


@pytest.mark.gpu
def test_cuda_sm90_reads_strided_layouts_and_zeroes_empty_rows(cuda):
    """[B, L, H, Dh] activations and a [B, buf, Hkv, Dh] cache prefix read
    in place, the output in q's layout; with more queries than keys under
    causal, the rows that see no key are exactly 0."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(2, 70, 6, 64, generator=gen, device=cuda).bfloat16()
    cache = torch.randn(2, 40, 3, 64, generator=gen, device=cuda).bfloat16()
    q, kv = x.transpose(1, 2), cache[:, :33].transpose(1, 2)
    before = fa.SM90_LAUNCHES
    got = fa.flash_attention(q, kv, kv, causal=True, window=48)
    assert fa.SM90_LAUNCHES == before + 1
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(q, kv, kv, window=48).float(),
                               rtol=3e-2, atol=3e-2)
    q = torch.randn(1, 4, 70, 64, generator=gen, device=cuda).bfloat16()
    k = torch.randn(1, 2, 6, 64, generator=gen, device=cuda).bfloat16()
    out = fa.flash_attention(q, k, k, causal=True)
    assert torch.equal(out[:, :, :64], torch.zeros_like(out[:, :, :64]))
    torch.testing.assert_close(out.float(), ref.flash_attention_ref(q, k, k).float(),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_cuda_sm90_gives_the_same_bits_twice(cuda, dh):
    """No atomics and no split over keys: a second call repeats the first."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(2, 8, 300, dh, generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn(2, 2, 300, dh, generator=gen, device=cuda).bfloat16() for _ in range(2))
    assert torch.equal(fa.flash_attention(q, k, v), fa.flash_attention(q, k, v))


@pytest.mark.gpu
def test_cuda_flash_attention_reads_the_cache_in_place(cuda):
    """Decode over a [B, buf, Hkv, Dh] cache prefix (a strided view), and
    rows with no key (zeros, not NaN)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    cache = torch.randn(4, 32, 8, 128, generator=gen, device=cuda).bfloat16()
    q = torch.randn(4, 1, 64, 128, generator=gen, device=cuda).bfloat16()
    kv = cache[:, :17].transpose(1, 2)
    got = fa.flash_attention(q.transpose(1, 2), kv, kv)
    want = ref.flash_attention_ref(q.transpose(1, 2), kv, kv)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)
    q = torch.randn(1, 2, 6, 32, generator=gen, device=cuda)
    k = torch.randn(1, 1, 3, 32, generator=gen, device=cuda)
    out = fa.flash_attention(q, k, k, causal=True)
    assert torch.equal(out[:, :, :3], torch.zeros_like(out[:, :, :3]))
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, k), rtol=2e-3, atol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_moe_gather_matches_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(4)
    for g, t, r, e, c, d in [(1, 640, 0, 8, 256, 64), (4, 1, 8, 384, 1, 7168),
                             (3, 50, 40, 16, 5, 130), (2, 5, 9, 3, 4, 3)]:
        x = torch.randn(g, t, d, generator=gen, device=cuda).to(dtype)
        rows = (torch.randint(0, t, (g, r), generator=gen, device=cuda, dtype=torch.int32)
                if r else None)
        n = r or t
        sizes = torch.randint(0, c + 1, (g, e), generator=gen, device=cuda, dtype=torch.int32)
        offs = torch.randint(-2, n + 2, (g, e), generator=gen, device=cuda, dtype=torch.int32)
        before = md.LAUNCHES
        got = md.moe_gather(x, offs, sizes, c, rows=rows)
        assert md.LAUNCHES == before + 1
        assert torch.equal(got, ref.moe_gather_ref(x, rows, offs, sizes, c))


@pytest.mark.gpu
@pytest.mark.parametrize("n_tokens", [LM_BATCH, 4096])
def test_cuda_moe_gather_at_the_kimi_shapes(cuda, n_tokens):
    """Kimi-K2's dispatch at full width in bf16, through the MoE layer's own
    groups, capacity and routing of random top-k experts: the decode step
    ([4, 384, 1, 7168], 4 tokens) and a 4096-token prefill ([32, 384, 4,
    7168]), byte-exact."""
    cfg = get_config("kimi-k2-1t-a32b")
    e, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    gen = torch.Generator(device=cuda).manual_seed(n_tokens)
    g = moe_mod._dispatch_groups(n_tokens)
    tg = n_tokens // g
    cap = int(max(1, math.ceil(cfg.moe_capacity_factor * tg * k / e)))
    x = torch.randn(g, tg, d, generator=gen, device=cuda).bfloat16()
    top_e = torch.rand(g, tg, e, generator=gen, device=cuda).topk(k, dim=-1).indices
    _, order, offsets, sizes = moe_mod.route(top_e, e, cap)
    rows = (order // k).to(torch.int32)
    offsets, sizes = offsets.to(torch.int32), sizes.to(torch.int32)
    got = md.moe_gather(x, offsets, sizes, cap, rows)
    assert got.shape == (g, e, cap, d)
    assert torch.equal(got, ref.moe_gather_ref(x, rows, offsets, sizes, cap))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,shift", [
    (torch.float32, 37, 0), (torch.bfloat16, 37, 0), (torch.uint8, 37, 0),
    (torch.float32, 64, 1), (torch.bfloat16, 64, 1), (torch.uint8, 64, 1)])
def test_cuda_moe_gather_copies_every_alignment(cuda, dtype, d, shift):
    """Rows whose size or base address allows only 4-, 2- or 1-byte words
    (the token table starts ``shift`` elements into its buffer), with sizes
    of 0, at and above capacity (and negative), stay byte-exact."""
    gen = torch.Generator(device=cuda).manual_seed(d + shift)
    g, t, r, e, c = 3, 40, 50, 24, 4
    buf = torch.randint(0, 250, (g * t * d + shift,), generator=gen, device=cuda).to(dtype)
    x = buf[shift:].view(g, t, d)
    rows = torch.randint(0, t, (g, r), generator=gen, device=cuda, dtype=torch.int32)
    choice = torch.tensor([0, c, c + 5, -2, 1, 3], dtype=torch.int32, device=cuda)
    sizes = choice[torch.randint(0, 6, (g, e), generator=gen, device=cuda)]
    offs = torch.randint(-2, r + 2, (g, e), generator=gen, device=cuda, dtype=torch.int32)
    before = md.LAUNCHES
    got = md.moe_gather(x, offs, sizes, c, rows=rows)
    assert md.LAUNCHES == before + 1
    assert torch.equal(got, ref.moe_gather_ref(x, rows, offs, sizes, c))
    assert torch.equal(got[sizes <= 0], torch.zeros_like(got[sizes <= 0]))


def _smoke_model(arch: str, dtype, device, seed: int = 0) -> Model:
    model = Model(smoke_config(arch), dtype=dtype, device=device)
    return model.init(torch.Generator(device=device).manual_seed(seed))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "kimi-k2-1t-a32b"])
def test_cuda_decode_matches_forward(cuda, arch):
    """Decode through the KV cache (the kernel at Lq = 1) agrees with the
    whole-sequence forward (Lq = S) at every position, float32, within
    tests/test_models.py's 2e-3 * scale."""
    cfg = dataclasses.replace(smoke_config(arch), moe_capacity_factor=16.0)  # no drops
    model = Model(cfg, dtype=torch.float32, device=cuda)
    model.init(torch.Generator(device=cuda).manual_seed(1))
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(2))
    before = (fa.LAUNCHES, md.LAUNCHES)
    full, _ = model.forward(toks)
    cache = model.init_cache(2, 16)
    for t in range(16):
        lg, cache = model.decode_step(cache, toks[:, t:t + 1])
        err = float((lg[:, 0] - full[:, t]).abs().max())
        assert err < 2e-3 * max(float(full[:, t].abs().max()), 1.0), (arch, t, err)
    assert fa.LAUNCHES > before[0]
    assert (md.LAUNCHES > before[1]) == cfg.moe


@pytest.mark.gpu
def test_cuda_lm_matches_cpu(cuda):
    """The same weights on the card (kernels) and on the CPU (plain
    versions) give the same logits, float32."""
    cpu = _smoke_model("kimi-k2-1t-a32b", torch.float32, "cpu")
    gpu = Model(cpu.cfg, dtype=torch.float32, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, cpu.cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(3))
    want, want_aux = cpu.forward(toks)
    got, aux = gpu.forward(toks.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    # the same assignments are dropped; the mean is taken in another order
    assert float(aux["drop_fraction"]) == pytest.approx(float(want_aux["drop_fraction"]),
                                                        abs=1e-6)
    assert float(aux["drop_fraction"]) > 0


@pytest.mark.gpu
def test_cuda_generate_is_deterministic(cuda):
    """Two bf16 runs give the same tokens (the MoE combine has no atomics)."""
    model = _smoke_model("kimi-k2-1t-a32b", torch.bfloat16, cuda)
    prompts = torch.randint(0, model.cfg.vocab_size, (4, 8), device=cuda,
                            generator=torch.Generator(device=cuda).manual_seed(5))
    a = serve.generate(model, prompts, 8)
    b = serve.generate(model, prompts, 8)
    assert torch.equal(a, b)
    assert serve.main(["--arch", "qwen3-0.6b", "--smoke", "--batch", "2", "--prompt-len", "4",
                       "--gen-len", "4"]) == 0
