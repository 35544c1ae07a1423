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
Attention takes its route by dtype and shape: bfloat16 the tensor-core
(sm90) kernel, which multiplies bf16 operands (P rounded to bf16) and so
is held to the plain float32 arithmetic within bf16's 3e-2; float32 the
CUDA-core kernel's decode route at few query rows per kv head (a decode
step) and its tile route otherwise.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.algorithms import sources
from repro_torch.batch import BatchEngine
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
L = sr.SPLIT_LEN  # the chunk length of both graph kernels' work lists
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
             (1, 2, 2, 100, 100, 32), (2, 16, 2, 9, 300, 128), (1, 4, 4, 20, 10, 256),
             # float32 tile route: the large tile (33 x 4 blocks fill the card) one row
             # below and above its 128 rows, Lk > Lq; rows with no key (Lq > Lk)
             (33, 4, 4, 127, 140, 64), (33, 4, 4, 129, 129, 128), (2, 8, 2, 40, 10, 256)]
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


def _sr_streams(cuda, dtype, seed: int, normal: bool = False) -> dict:
    """shuffle_reduce's streams, each as (call, vals, offsets): the call
    runs one route of the wrapper on the stream, ``vals`` and ``offsets``
    are the sorted stream it reduces. Values are integers in [-8, 8], so no
    partial sum of up to 2^21 of them leaves float32's exact integers and
    every summation order gives the plain version's bits; ``normal`` draws
    float32 values from a normal distribution instead."""
    rng = np.random.default_rng(seed)
    n_bins = 524_288

    def values(n):
        if normal:
            return torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda)
        return torch.from_numpy(rng.integers(-8, 9, n).astype(np.int32)).to(dtype).to(cuda)

    out = {}
    # the one-bin counter: every update into one bin (a broadcast index)
    vals = values(n_bins)
    one = torch.tensor(77, dtype=torch.int32, device=cuda).expand(n_bins)
    out["counter"] = (lambda op, v=vals: sr.shuffle_reduce(v, one, n_bins, op), vals,
                      sr.route(one, n_bins)[1])
    # a 2^20-update bin among bins around SPLIT_LEN and the kernel's other
    # length classes (64 and 256 updates), empty bins
    # and a short rest, through the bind's list and the per-launch one
    counts = np.concatenate([[0, 2**20, L - 1, L, L + 1, 0, 2 * L, 2 * L + 1, 64, 65, 256, 257, 0],
                             rng.integers(0, 90, 20_000)])
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)).to(cuda)
    vals = values(int(counts.sum()))
    split = sr.split_bins(offsets, vals.shape[0])
    n_out = counts.shape[0]
    out["hub_per_bind"] = (lambda op, v=vals: sr.shuffle_reduce_sorted(v, offsets, n_out, op,
                                                                       split), vals, offsets)
    out["hub_per_launch"] = (lambda op, v=vals: sr.shuffle_reduce_sorted(v, offsets, n_out, op),
                             vals, offsets)
    # the unsorted wrapper with a hub (40% of the updates) and dropped indices
    n = 600_000
    idx = torch.from_numpy(np.where(rng.random(n) < 0.4, 7, rng.integers(-5, 10_005, n))
                           .astype(np.int32)).to(cuda)
    vals = values(n)
    perm, offs = sr.route(idx, 10_000)
    out["unsorted_hub"] = (lambda op, v=vals: sr.shuffle_reduce(v, idx, 10_000, op), vals[perm],
                           offs)
    # sparse launches: 1,024 and 131,072 updates into 524,288 bins
    for m in (1024, 131_072):
        idx_m = torch.from_numpy(rng.integers(0, n_bins, m).astype(np.int32)).to(cuda)
        vals = values(m)
        perm, offs = sr.route(idx_m, n_bins)
        out[f"sparse_{m}"] = (lambda op, v=vals, i=idx_m: sr.shuffle_reduce(v, i, n_bins, op),
                              vals[perm], offs)
    return out


SR_STREAMS = ["counter", "hub_per_bind", "hub_per_launch", "unsorted_hub", "sparse_1024",
              "sparse_131072"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("op", ["+", "min", "max"])
def test_cuda_shuffle_reduce_walks_the_work_list_on_every_route(cuda, dtype, op):
    """Every route (the bind's list, the stride-0 list, the per-launch list
    built on the device) gives the plain version's answer exactly, counts
    one launch a call, and the routes that build their list per launch
    read nothing back to the host (sync debug mode "error")."""
    for name, (call, vals, offsets) in _sr_streams(cuda, dtype, seed=21).items():
        want = ref.segment_reduce_ref(vals, offsets, op)
        torch.cuda.synchronize()
        before = sr.LAUNCHES
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = call(op)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert sr.LAUNCHES == before + 1, name
        assert torch.equal(got, want), name


@pytest.mark.gpu
@pytest.mark.parametrize("name", SR_STREAMS)
def test_cuda_shuffle_reduce_float_sum_repeats_its_bits(cuda, name):
    """Non-integer floats: two calls give the same bits, within the bound
    of two summation orders of the plain version."""
    call, vals, offsets = _sr_streams(cuda, torch.float32, seed=22, normal=True)[name]
    a, b = call("+"), call("+")
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    want = ref.segment_reduce_ref(vals, offsets, "+")
    ids = ref.bin_ids(offsets).long()  # the updates the bins hold (dropped ones sort outside)
    n_b = torch.bincount(ids, minlength=a.shape[0]).double()
    abs_sum = torch.zeros(a.shape[0], dtype=torch.float64, device=cuda).index_add_(
        0, ids, vals[int(offsets[0]):int(offsets[-1])].abs().double())
    assert bool(((a.double() - want.double()).abs() <= 2 * (n_b + 5) * 2.0**-24 * abs_sum).all())


@pytest.mark.gpu
def test_cuda_launch_list_matches_its_plain_version(cuda):
    """The split list kernel writes launch_split's plain list, whose used
    slots are split_bins' list (tests/test_torch_shuffle_split.py)."""
    rng = np.random.default_rng(23)
    for start, counts, cut in [
            (0, [0, 2**20, L - 1, L, L + 1, 0, 2 * L, 2 * L + 1, 0], 0),
            (-3 * L, list(rng.integers(0, 4 * L, 300)), 5 * L),
            (0, [0] * 1000 + [9 * L + 3] + [0] * 1000, 0),
            (0, list(rng.integers(0, 40, 524_288)), 0)]:
        offsets = torch.from_numpy(np.concatenate([[start], start + np.cumsum(counts)])
                                   .astype(np.int32))
        n = max(0, int(offsets[-1]) - cut)
        want = sr.launch_split(offsets, n)
        got = sr.launch_split(offsets.to(cuda), n)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
@pytest.mark.parametrize("length", [0, 1, 64, 65, 257, L, L + 1, 4 * L + 9, 2**17])
def test_cuda_a_bin_sums_the_same_wherever_it_sits(cuda, length):
    """The same float values in one bin give the same bits after any other
    bins, through the bind's list and the per-launch one."""
    rng = np.random.default_rng(length)
    bin_vals = torch.from_numpy(rng.normal(size=length).astype(np.float32)).to(cuda)
    seen = set()
    for before in ([], [3], [L + 7, 0, 40], [5 * L + 1, 100, 2], list(rng.integers(0, 90, 500))):
        counts = np.array(list(before) + [length, 9, 2 * L])
        offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
        offsets = offsets.to(cuda)
        vals = torch.from_numpy(rng.normal(size=int(counts.sum())).astype(np.float32)).to(cuda)
        pos = int(sum(before))
        vals[pos:pos + length] = bin_vals
        split = sr.split_bins(offsets, vals.shape[0])
        for s in (split, None):
            got = sr.shuffle_reduce_sorted(vals, offsets, counts.shape[0], "+", s)
            seen.add(got[len(before)].view(torch.int32).item())
    assert len(seen) == 1


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


ARTIFACT_PROGRAMS = [("BFS_ECP", {"root": 3}), ("SSSP", {"root": 3}), ("PAGERANK", {"iters": 5})]


def _artifact_graph():
    return generators.power_law(2000, 30000, seed=5, weighted=True)


def _artifact_roundtrip(cuda, tmp_path, name, params):
    """``lower`` -> ``save`` -> ``load_accelerator`` -> ``bind`` -> ``run`` on
    the card beside ``bind(g).run`` on the card; returns (want, got,
    loaded accelerator, launches of the loaded run)."""
    g = _artifact_graph()
    prog = repro_torch.compile(getattr(sources, name))
    want = prog.bind(g).run(**params)
    acc = prog.lower(graph=g)
    loaded = repro_torch.load_accelerator(acc.save(str(tmp_path / name)))
    before = (sr.LAUNCHES, es.LAUNCHES)
    got = loaded.bind(g).run(**params)
    return want, got, loaded, (sr.LAUNCHES - before[0], es.LAUNCHES - before[1])


@pytest.mark.gpu
@pytest.mark.parametrize("name,params", ARTIFACT_PROGRAMS)
def test_cuda_artifact_roundtrip_is_bit_identical_to_bind(cuda, tmp_path, name, params):
    want, got, loaded, launches = _artifact_roundtrip(cuda, tmp_path, name, params)
    for prop, a in want.properties.items():
        b = got.properties[prop]
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8)), prop
    assert got.host_env == want.host_env
    assert got.stats.kernel_launches == want.stats.kernel_launches
    assert sum(launches) > 0
    # the libraries were built when the first lowering ran: no nvcc on load
    assert {k.mode for k in loaded.report().kernels} == {"aot-loaded"}
    assert all(info["cached"] for info in loaded.library.builds.values())
    # a rebind reuses every key the first bind warmed: its run compiles nothing
    again = loaded.bind(_artifact_graph()).run(**params)
    assert again.stats.compile_time_s == 0.0
    assert again.stats.run_time_s == again.stats.wall_time_s > 0


@pytest.mark.gpu
def test_cuda_artifact_path_launches_both_graph_kernels(cuda, tmp_path):
    total = [0, 0]
    for name, params in ARTIFACT_PROGRAMS:
        _, _, _, launches = _artifact_roundtrip(cuda, tmp_path, name, params)
        total = [total[0] + launches[0], total[1] + launches[1]]
    assert total[0] > 0 and total[1] > 0, total


# --------------------------------------------------------------------------
# batched launches: K rows over one bin layout and work list
# --------------------------------------------------------------------------


def _batched_stream(cuda, dtype, k: int, seed: int):
    """K rows of values over one skewed bin layout (a 2^17-update bin, bins
    around SPLIT_LEN, empty bins, a short rest) and its work list: float32
    rows drawn from a normal distribution (so only the one-row fold order
    gives the one-row bits), int32 rows over all 32 bits."""
    rng = np.random.default_rng(seed)
    counts = np.concatenate([[0, 2**17, L - 1, L, L + 1, 0, 2 * L + 1, 64, 65, 257, 0],
                             rng.integers(0, 40, 5_000)])
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)).to(cuda)
    n = int(counts.sum())
    if dtype == torch.float32:
        vals = rng.normal(size=(k, n)).astype(np.float32)
    else:
        vals = rng.integers(-2**31, 2**31, (k, n), dtype=np.int64).astype(np.int32)
    return torch.from_numpy(vals).to(cuda), offsets, sr.split_bins(offsets, n)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,op", [(torch.float32, "+"), (torch.float32, "min"),
                                      (torch.int32, "+"), (torch.int32, "min"),
                                      (torch.int32, "max"), (torch.int32, "|")])
def test_cuda_shuffle_reduce_batched_rows_equal_one_row_launches(cuda, dtype, op):
    """One launch of K rows: each row has the bits of its own one-row launch
    (float + too), with the bind-style list and the per-launch one, and
    equals the plain version (exactly where the order cannot matter)."""
    k = 6
    vals, offsets, split = _batched_stream(cuda, dtype, k, seed=11)
    n_out = offsets.shape[0] - 1
    for lst in (split, None):
        before = sr.LAUNCHES
        got = sr.shuffle_reduce_sorted_batched(vals, offsets, n_out, op, lst)
        assert sr.LAUNCHES == before + 1 and got.shape == (k, n_out)
        rows = torch.stack([sr.shuffle_reduce_sorted(vals[q], offsets, n_out, op, lst)
                            for q in range(k)])
        assert torch.equal(_bits(got), _bits(rows))
    # the oracle on the CPU, float values in float64: on the card the plain
    # version scatters with atomics, so its float32 sums change from run to run
    src = vals.cpu().double() if dtype == torch.float32 else vals.cpu()
    want = ref.segment_reduce_batched_ref(src, offsets.cpu(), op).to(cuda)
    if dtype == torch.float32 and op == "+":
        assert torch.allclose(got.double(), want, rtol=1e-4, atol=1e-3)
    else:
        assert torch.equal(got, want.to(dtype))


@pytest.mark.gpu
def test_cuda_shuffle_reduce_batched_row_stride_zero_and_routes(cuda):
    """A row expanded over the batch (stride 0) is read in place; the
    unsorted batched wrapper routes a shared index once and a per-row index
    per row, each equal to one-row calls."""
    vals, offsets, split = _batched_stream(cuda, torch.float32, 1, seed=12)
    n_out = offsets.shape[0] - 1
    shared = vals[0].expand(5, -1)
    got = sr.shuffle_reduce_sorted_batched(shared, offsets, n_out, "+", split)
    one = sr.shuffle_reduce_sorted(vals[0], offsets, n_out, "+", split)
    assert torch.equal(_bits(got), _bits(one.expand(5, -1)))
    gen = torch.Generator(device=cuda).manual_seed(3)
    v = torch.randint(-50, 50, (4, 5000), generator=gen, device=cuda, dtype=torch.int32)
    idx = torch.randint(-3, 700, (4, 5000), generator=gen, device=cuda, dtype=torch.int32)
    for ix in (idx, idx[0]):
        for op in ("+", "max", "|"):
            got = sr.shuffle_reduce_batched(v, ix, 690, op)
            rows = torch.stack([sr.shuffle_reduce(v[q], ix if ix.dim() == 1 else ix[q], 690, op)
                                for q in range(4)])
            assert torch.equal(got, rows), (op, ix.dim())
            assert torch.equal(got, ref.shuffle_reduce_batched_ref(v, ix, 690, op))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("apply_op", ["add", "mul", "src"])
def test_cuda_edge_stream_batched_rows_equal_one_row_launches(cuda, dtype, apply_op):
    """K rows of the vertex side over one skewed edge stream: per-row or
    shared (stride 0) mask and weights, every op of the dtype (| for
    int32); each row has its one-row launch's bits (float rows drawn from a
    normal distribution, so only the one-row fold order gives them)."""
    vval, vact, src_s, eid_s, w, offsets = _skewed_stream(cuda, dtype, seed=13)
    k = 4
    gen = torch.Generator(device=cuda).manual_seed(5)
    if dtype == torch.float32:
        rows_v = torch.randn(k, vval.shape[0], generator=gen, device=cuda)
    else:
        rows_v = torch.randint(-2**31, 2**31 - 1, (k, vval.shape[0]), generator=gen,
                               device=cuda, dtype=torch.int32)
    rows_a = torch.stack([vact[torch.randperm(vact.shape[0], generator=gen, device=cuda)]
                          for _ in range(k)])
    rows_w = torch.stack([w[torch.randperm(w.shape[0], generator=gen, device=cuda)]
                          for _ in range(k)])
    split = sr.split_bins(offsets, src_s.shape[0])
    eid = None if apply_op == "src" else eid_s
    for op in ("+", "min", "max") + (("|",) if dtype == torch.int32 else ()):
        for act, ww in ((rows_a, rows_w), (vact, w)):
            ww = None if apply_op == "src" else ww
            before = es.LAUNCHES
            got = es.edge_stream_gather_batched(rows_v, act, src_s, eid, ww, offsets, apply_op,
                                                op, split)
            assert es.LAUNCHES == before + 1
            rows = torch.stack([es.edge_stream_gather(
                rows_v[q], act if act.dim() == 1 else act[q], src_s, eid,
                None if ww is None else (ww if ww.dim() == 1 else ww[q]), offsets, apply_op, op,
                split) for q in range(k)])
            assert torch.equal(_bits(got), _bits(rows)), (op, act.dim())
            if not (dtype == torch.float32 and op == "+"):
                want = ref.edge_stream_gather_batched_ref(rows_v, act, src_s, eid, ww, offsets,
                                                          apply_op, op)
                assert torch.equal(got, want), (op, act.dim())


ROW_GROUP_KS = [2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 33, 64]  # R - 1, R, R + 1, 2R + 1 of R = 8, 16


def _row_group_stream(cuda, dtype, k: int, seed: int):
    """K rows over a skewed stream (split hub bins, bins around L, a
    stretch of 64 empty bins): float rows from a normal distribution with
    some -0.0 and int32 rows over all 32 bits; per-row flags and weights
    (K rows) beside the shared ones."""
    rng = np.random.default_rng(seed)
    counts = np.concatenate([[0, 3 * L + 7, L - 1, L, L + 1, 0], np.zeros(64, np.int64),
                             [2 * L + 1, 40, 33, 32], rng.integers(0, 17, 1500),
                             rng.integers(0, 90, 200)])
    n_v, n_e = 2000, int(counts.sum())
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    src_s = torch.from_numpy(rng.integers(0, n_v, n_e).astype(np.int32))
    eid_s = torch.from_numpy(rng.permutation(n_e).astype(np.int32))
    if dtype == torch.float32:
        vval = rng.normal(size=(k, n_v)).astype(np.float32)
        vval[rng.random((k, n_v)) < 0.02] = -0.0
        w = rng.normal(size=(k, n_e)).astype(np.float32)
    else:
        vval = rng.integers(-2**31, 2**31, (k, n_v), dtype=np.int64).astype(np.int32)
        w = rng.integers(-2**31, 2**31, (k, n_e), dtype=np.int64).astype(np.int32)
    vact = rng.random((k, n_v)) < 0.6
    return [torch.from_numpy(t).to(cuda) for t in (vval, vact, w)] + [
        t.to(cuda) for t in (src_s, eid_s, offsets)]


@pytest.mark.gpu
@pytest.mark.parametrize("k", ROW_GROUP_KS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("apply_op", ["add", "mul", "src"])
def test_cuda_edge_stream_row_groups_equal_one_row_launches(cuda, k, dtype, apply_op):
    """The batched walk over groups of rows (full and partial groups, one
    group at K = 2, many at K = 64): each row has its one-row launch's bits
    under every op, with per-row and shared (stride 0) flags and weights."""
    vval, vact, w, src_s, eid_s, offsets = _row_group_stream(cuda, dtype, k, seed=20 + k)
    split = sr.split_bins(offsets, src_s.shape[0])
    assert split.bins.shape[0] == 3  # 3L + 7, L + 1 and 2L + 1 edges
    eid = None if apply_op == "src" else eid_s
    for op in ("+", "min", "max") + (("|",) if dtype == torch.int32 else ()):
        for act, ww in ((vact, w), (vact[0], w[0])):
            ww = None if apply_op == "src" else ww
            before = es.LAUNCHES
            got = es.edge_stream_gather_batched(vval, act, src_s, eid, ww, offsets, apply_op, op,
                                                split)
            assert es.LAUNCHES == before + 1 and got.shape == (k, offsets.shape[0] - 1)
            rows = torch.stack([es.edge_stream_gather(
                vval[q], act if act.dim() == 1 else act[q], src_s, eid,
                None if ww is None else (ww if ww.dim() == 1 else ww[q]), offsets, apply_op, op,
                split) for q in range(k)])
            assert torch.equal(_bits(got), _bits(rows)), (op, act.dim())
            if dtype == torch.int32:
                want = ref.edge_stream_gather_batched_ref(vval, act, src_s, eid, ww, offsets,
                                                          apply_op, op)
                assert torch.equal(got, want), (op, act.dim())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 9])
def test_cuda_edge_stream_row_groups_with_no_bins(cuda, k):
    """n_out = 0: a [K, 0] result, as the one-row launches give."""
    vval = torch.ones(k, 5, device=cuda)
    vact = torch.ones(k, 5, dtype=torch.bool, device=cuda)
    src_s = torch.zeros(0, dtype=torch.int32, device=cuda)
    offsets = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = es.edge_stream_gather_batched(vval, vact, src_s, None, None, offsets, "src", "+")
    assert got.shape == (k, 0)
    one = es.edge_stream_gather(vval[0], vact[0], src_s, None, None, offsets, "src", "+")
    assert one.shape == (0,)


@pytest.mark.gpu
def test_cuda_or_reduce_rejects_float(cuda):
    off = torch.tensor([0, 2], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        sr.shuffle_reduce_sorted(torch.ones(2, device=cuda), off, 1, "|")
    with pytest.raises(TypeError, match="int32"):
        es.edge_stream_gather_batched(torch.ones(2, 2, device=cuda),
                                      torch.ones(2, dtype=torch.bool, device=cuda),
                                      torch.zeros(2, dtype=torch.int32, device=cuda), None, None,
                                      off, "src", "|")


@pytest.mark.gpu
@pytest.mark.parametrize("algo", list(ALGORITHMS))
def test_cuda_bind_batch_matches_sequential_on_the_card(cuda, algo):
    """bind_batch(g).run_many on the card: every lane bit-identical to a
    sequential run on the card (float sums too: each row folds as its own
    launch does), BFS_ECP by MS-BFS, and the batch's launches went through
    the kernels."""
    g = generators.power_law(200, 1400, seed=5, weighted=True)
    name, params = ALGORITHMS[algo]
    prog = repro_torch.compile(getattr(sources, name))
    rng = np.random.default_rng(8)
    sets = []
    for _ in range(40 if algo == "bfs" else 6):
        p = dict(params)
        for key in ("root", "source"):
            if key in p:
                p[key] = int(rng.integers(0, 200))
        sets.append(p)
    sess = prog.bind(g)
    seq = [sess.run(**p) for p in sets]
    before = sr.LAUNCHES + es.LAUNCHES
    bat = prog.bind_batch(g).run_many(sets)
    assert sr.LAUNCHES + es.LAUNCHES > before
    assert bat[0].stats.batch_size == len(sets)
    assert (BatchEngine.MSBFS_NAME in bat[0].stats.kernel_launches) == (algo == "bfs")
    for a, b in zip(seq, bat):
        for prop, x in a.properties.items():
            assert np.array_equal(x.view(np.uint8), b.properties[prop].view(np.uint8)), prop
        assert a.host_env == b.host_env


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


# the (Dqk, Dv) pairs of the LM configs beside HEAD_DIMS: hubert (80),
# h2o-danube (120), MLA's prefill (192, 128) and absorbed decode (576, 512),
# the smoke MLA's; and 96, which no config uses, run at 128 as they are
NEW_PAIRS = [(80, 80), (120, 120), (192, 128), (576, 512), (48, 32), (80, 64), (96, 96)]
# route -> (dtype, group, lq, lk): a prefill on the tile route (more rows than
# DECODE_MAX_ROWS), a decode step (Lq = 1) over a cache with splits
PAIR_ROUTES = {"sm90": (torch.bfloat16, 2, 70, 130), "cuda_core": (torch.float32, 2, 70, 130),
               "decode": (torch.float32, 8, 1, 3000)}


def _pair_inputs(gen, dev, dqk, dv, dtype, group, lq, lk, hkv=2, b=2):
    q = torch.randn(b, hkv * group, lq, dqk, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, hkv, lk, dqk, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, hkv, lk, dv, generator=gen, device=dev).to(dtype)
    return q, k, v


def _pair_scale(dqk, dv):
    """MLA's scale is 1/sqrt(192) at both of its pairs; the others take the default."""
    return 1.0 / math.sqrt(192) if (dqk, dv) in ((192, 128), (576, 512)) else None


@pytest.mark.gpu
@pytest.mark.parametrize("dqk,dv", NEW_PAIRS)
@pytest.mark.parametrize("route", sorted(PAIR_ROUTES))
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0)])
def test_cuda_attention_head_dim_pairs_match_plain(cuda, dqk, dv, route, causal, window):
    """Every new (Dqk, Dv) pair on every route, causal, windowed and
    bidirectional, held to its plain version with the same scale; the
    call's route is read from the launch counters, and the output is
    [B, H, Lq, Dv]."""
    dtype, group, lq, lk = PAIR_ROUTES[route]
    gen = torch.Generator(device=cuda).manual_seed(dqk + dv)
    q, k, v = _pair_inputs(gen, cuda, dqk, dv, dtype, group, lq, lk)
    scale = _pair_scale(dqk, dv)
    assert fa._route(q, group) == route
    before = (fa.LAUNCHES, fa.SM90_LAUNCHES, fa.DECODE_LAUNCHES)
    got = fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale)
    moved = (fa.LAUNCHES - before[0], fa.SM90_LAUNCHES - before[1],
             fa.DECODE_LAUNCHES - before[2])
    assert moved == (1, int(route == "sm90"), int(route == "decode")), moved
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    assert got.shape == (q.shape[0], q.shape[1], lq, dv) and got.dtype == dtype
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=FA_TOL[dtype], atol=FA_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dqk,dv", [(48, 32), (80, 64), (576, 512)])
@pytest.mark.parametrize("route", sorted(PAIR_ROUTES))
def test_cuda_attention_reads_values_as_a_view_of_the_keys(cuda, dqk, dv, route):
    """MLA's absorbed decode: the values are the first Dv columns of the
    key rows (the latent cache, a view of one [B, L, Dqk] buffer with one
    kv head). Read in place, they give the bits of a contiguous copy, the
    same bits on a second call, and the plain version's answer."""
    dtype, group, lq, lk = PAIR_ROUTES[route]
    gen = torch.Generator(device=cuda).manual_seed(dqk)
    latent = torch.randn(2, lk, dqk, generator=gen, device=cuda).to(dtype)
    k = latent[:, None]  # [B, 1, Lk, Dqk]
    v = k[..., :dv]
    assert v.data_ptr() == k.data_ptr() and not v.is_contiguous()
    q = torch.randn(2, 16 * group, lq, dqk, generator=gen, device=cuda).to(dtype)
    scale = _pair_scale(dqk, dv)
    got = fa.flash_attention(q, k, v, scale=scale)
    assert torch.equal(got, fa.flash_attention(q, k, v.contiguous(), scale=scale))
    assert torch.equal(got, fa.flash_attention(q, k, v, scale=scale))
    torch.testing.assert_close(got.float(), ref.flash_attention_ref(q, k, v, scale=scale).float(),
                               rtol=FA_TOL[dtype], atol=FA_TOL[dtype])


@pytest.mark.gpu
def test_cuda_attention_refuses_a_pair_no_route_takes(cuda):
    """A (Dqk, Dv) pair wider than every instantiation (640), or whose rows
    are no whole 16-byte chunks (bf16 at 36), raises ValueError naming it on
    the card, and the source's widths entry refuses it; the plain version
    on the CPU takes it. 36 in float32 is whole chunks and runs at 64."""
    for dtype, d in ((torch.bfloat16, 640), (torch.float32, 640), (torch.bfloat16, 36)):
        q, k, v = (torch.randn(1, 2, 4, d, device=cuda).to(dtype) for _ in range(3))
        with pytest.raises(ValueError, match=rf"\({d}, {d}\)"):
            fa.flash_attention(q, k, v)
        q, k, v = (t.cpu() for t in (q, k, v))
        assert fa.flash_attention(q, k, v).shape == (1, 2, 4, d)
    assert fa.kernel_widths("decode", 36, 36) == (64, 64)
    q, k, v = (torch.randn(1, 2, 4, 36, device=cuda) for _ in range(3))
    torch.testing.assert_close(fa.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v),
                               rtol=FA_TOL[torch.float32], atol=FA_TOL[torch.float32])


# a (Dqk, Dv) pair of each instantiation of the tensor-core kernel
# (csrc/flash_attention_sm90.cu, FA90_WIDTHS), the configs' pairs among them
SM90_PAIRS = [(32, 32), (48, 32), (64, 64), (80, 64), (80, 80), (120, 120), (128, 128),
              (192, 128), (256, 256), (576, 512)]
# rows a block holds -> (group, Lq): a kv head of 52 rows (one consumer
# warpgroup) and of 200 (two, 128 rows a block, the last block's second
# warpgroup with 8 rows)
SM90_FORMS = {64: (4, 13), 128: (2, 100)}
SM90_MASKS = [(True, 0), (True, 48), (False, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dqk,dv", SM90_PAIRS)
@pytest.mark.parametrize("form", sorted(SM90_FORMS))
def test_cuda_sm90_forms_repeat_their_bits_with_and_without_lse(cuda, dqk, dv, form):
    """Every instantiation in both row forms (256 and 576 take the 64-row
    form only), causal, windowed and bidirectional, Lk > Lq: the plain version
    within bf16's 3e-2, the same bits on a second call, and, where Dv fits
    one value slice, the same output bits when the log-sum-exp is asked for,
    which is the plain one."""
    group, lq = SM90_FORMS[form]
    assert fa.sm90_form(dqk, dv, group * lq) == (64 if dqk >= 256 else form)
    gen = torch.Generator(device=cuda).manual_seed(dqk + dv + form)
    scale = _pair_scale(dqk, dv)
    for causal, window in SM90_MASKS:
        q, k, v = _pair_inputs(gen, cuda, dqk, dv, torch.bfloat16, group, lq, lq + 37)
        got = fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale)
        assert torch.equal(got, fa.flash_attention(q, k, v, causal=causal, window=window,
                                                   scale=scale))
        torch.testing.assert_close(
            got.float(), ref.flash_attention_ref(q, k, v, causal, window, scale).float(),
            rtol=3e-2, atol=3e-2, msg=lambda m: f"causal={causal} window={window}: {m}")
        if dv > 256:
            continue
        out, lse = fa._launch("sm90", q, k, v, causal, window,
                              scale if scale is not None else 1.0 / math.sqrt(dqk), with_lse=True)
        assert torch.equal(out, got)
        want = ref.attention_lse_ref(q, k, causal, window, scale)
        assert torch.equal(torch.isfinite(lse), torch.isfinite(want))
        live = torch.isfinite(want)
        err = float((lse[live] - want[live]).abs().max())
        assert err <= 1e-5 * max(1.0, float(want[live].abs().max())), err


@pytest.mark.gpu
@pytest.mark.parametrize("dqk,dv", [(80, 80), (192, 128), (256, 256), (576, 512)])
@pytest.mark.parametrize("scale", [-0.3, 0.0, 1e-3])
def test_cuda_sm90_takes_any_scale(cuda, dqk, dv, scale):
    """The kernel folds the scale's sign into Q (a scale of 0 zeroes it),
    with Q in registers (80, (192, 128)) and in shared memory (256, 576):
    a negative, a zero and a small scale each match the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(dqk + 5)
    q, k, v = _pair_inputs(gen, cuda, dqk, dv, torch.bfloat16, 2, 70, 130)
    for causal, window in SM90_MASKS:
        got = fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale)
        torch.testing.assert_close(
            got.float(), ref.flash_attention_ref(q, k, v, causal, window, scale).float(),
            rtol=3e-2, atol=3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dqk,dv", [p for p in SM90_PAIRS if p[0] < 256])
@pytest.mark.parametrize("causal,window", SM90_MASKS)
def test_cuda_sm90_row_forms_agree(cuda, dqk, dv, causal, window):
    """Where both forms can run: two query heads a kv head over 64
    positions (128 rows: the two-consumer form, a warpgroup a head) against
    each head alone (64 rows: the one-consumer form), within bf16's 3e-2."""
    gen = torch.Generator(device=cuda).manual_seed(dqk + 3 * dv)
    q, k, v = _pair_inputs(gen, cuda, dqk, dv, torch.bfloat16, 2, 64, 150)
    scale = _pair_scale(dqk, dv)
    assert fa.sm90_form(dqk, dv, 128) == 128 and fa.sm90_form(dqk, dv, 64) == 64
    both = fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale)
    for g in range(2):
        one = fa.flash_attention(q[:, g::2], k, v, causal=causal, window=window, scale=scale)
        torch.testing.assert_close(both[:, g::2].float(), one.float(), rtol=3e-2, atol=3e-2)


# the float32 tile route's masks: a window shorter than either key tile
TILE_MASKS = [(True, 0), (False, 0), (True, 5), (False, 5)]


@pytest.mark.gpu
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("causal,window", TILE_MASKS)
def test_cuda_tile_route_matches_plain_at_both_tiles(cuda, dh, small, causal, window):
    """The float32 tile route under its large and its small tile (the
    shape picks it: 33 x 4 or 17 x 8 kv heads fill the card, 1 x 2 do
    not), with the rows one below and one above two tiles, Lk > Lq, GQA,
    and a window shorter than a key tile, q, k and v read in place from
    [B, L, H, Dh] layouts: one tile-route launch a call, within 2e-3 of the
    plain version, and the same bits on two calls."""
    gen = torch.Generator(device=cuda).manual_seed(dh + 2 * small)
    form = "small" if small else "large"
    bm = fa.tile_shape(dh, form)[0]
    b, hkv = (1, 2) if small else (33, 4)
    cases = [(b, hkv, 1, 2 * bm - 1, 2 * bm + 20), (b, hkv, 1, 2 * bm + 1, 2 * bm + 1),
             (b if small else 17, hkv if small else 8, 4, 9 if small else 33, 40)]
    for b, hkv, group, lq, lk in cases:
        plan = fa.tile_plan(b, hkv, group * lq, dh, fa._sm_count(0))
        assert plan[:2] == fa.tile_shape(dh, form), plan
        x = torch.randn(b, lq, hkv * group, dh, generator=gen, device=cuda)
        ck, cv = (torch.randn(b, lk + 3, hkv, dh, generator=gen, device=cuda) for _ in range(2))
        q, k, v = x.transpose(1, 2), ck[:, :lk].transpose(1, 2), cv[:, :lk].transpose(1, 2)
        before = fa_launches()
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        assert fa_launches() == (before[0] + 1, before[1], before[2])
        assert got.transpose(1, 2).is_contiguous()
        torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, causal, window),
                                   rtol=2e-3, atol=2e-3,
                                   msg=lambda m: f"{(b, hkv, group, lq, lk)}: {m}")
        assert torch.equal(got, fa.flash_attention(q, k, v, causal=causal, window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_cuda_tile_route_zeroes_rows_without_keys(cuda, dh):
    """More queries than keys under causal: the first rows see no key and
    come out exactly 0 (not NaN) on the tile route, the rest match the
    plain version; no key at all gives zeros."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn(1, 8, 40, dh, generator=gen, device=cuda)
    k, v = (torch.randn(1, 2, 10, dh, generator=gen, device=cuda) for _ in range(2))
    assert fa._route(q, 4) == "cuda_core"
    out = fa.flash_attention(q, k, v, causal=True)
    assert torch.equal(out[:, :, :30], torch.zeros_like(out[:, :, :30]))
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, v), rtol=2e-3, atol=2e-3)
    empty = torch.zeros(1, 2, 0, dh, device=cuda)
    out = fa.flash_attention(q, empty, empty, causal=False)
    assert torch.equal(out, torch.zeros_like(out))


def fa_launches():
    return fa.LAUNCHES, fa.SM90_LAUNCHES, fa.DECODE_LAUNCHES


DECODE_LK = (1, 2, 31, 32, 33, 4096)  # around the teams' rounds; the last split across blocks


@pytest.mark.gpu
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("lq", [1, 2])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 48)])
def test_cuda_decode_route_matches_plain(cuda, dh, group, lq, causal, window):
    """The float32 decode route (few query rows per kv head) at every head
    dim, GQA group, Lq of 1 and 2 and mask, over key lengths around its
    rounds and a 4,096-key cache that decode_splits cuts across blocks:
    one launch a call, the decode counter up by one, within 2e-3 of the
    plain version."""
    gen = torch.Generator(device=cuda).manual_seed(dh + group + lq)
    hkv = 2
    for lk in DECODE_LK:
        q = torch.randn(2, hkv * group, lq, dh, generator=gen, device=cuda)
        k, v = (torch.randn(2, hkv, lk, dh, generator=gen, device=cuda) for _ in range(2))
        assert fa._route(q, group) == "decode"
        before = (fa.LAUNCHES, fa.SM90_LAUNCHES, fa.DECODE_LAUNCHES)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        assert (fa.LAUNCHES, fa.SM90_LAUNCHES, fa.DECODE_LAUNCHES) == \
            (before[0] + 1, before[1], before[2] + 1)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3,
                                   msg=lambda m: f"lk={lk}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("lk", [17, 32, 4096])
def test_cuda_decode_route_reads_the_cache_in_place(cuda, lk):
    """qwen3-0.6b's decode step: q [4, 16, 1, 128] out of a [B, 1, H, Dh]
    activation and the [B, buf, Hkv, Dh] cache prefix, both read through
    strides (no copy), the output in q's layout; and a granite-20b-like
    group of 48 rows over one kv head (six row tiles)."""
    gen = torch.Generator(device=cuda).manual_seed(lk)
    x = torch.randn(4, 1, 16, 128, generator=gen, device=cuda)
    cache = torch.randn(4, lk + 5, 8, 128, generator=gen, device=cuda)
    q, kv = x.transpose(1, 2), cache[:, :lk].transpose(1, 2)
    assert fa._aligned(kv) is kv and fa._aligned(q) is q
    before = fa.DECODE_LAUNCHES
    got = fa.flash_attention(q, kv, kv)
    assert fa.DECODE_LAUNCHES == before + 1
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got, ref.flash_attention_ref(q, kv, kv), rtol=2e-3, atol=2e-3)
    q = torch.randn(2, 48, 1, 128, generator=gen, device=cuda)
    k, v = (torch.randn(2, 1, lk, 128, generator=gen, device=cuda) for _ in range(2))
    got = fa.flash_attention(q, k, v)
    assert fa.DECODE_LAUNCHES == before + 2
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v), rtol=2e-3, atol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", fa.HEAD_DIMS)
def test_cuda_decode_route_zeroes_rows_without_keys(cuda, dh):
    """Rows whose keys are all masked come out exactly 0: causal with more
    queries than keys, a window of 1 over a cache cut into splits (every
    split but one holds none of a row's keys), and no key at all."""
    gen = torch.Generator(device=cuda).manual_seed(dh)
    q = torch.randn(1, 8, 2, dh, generator=gen, device=cuda)
    k = torch.randn(1, 2, 1, dh, generator=gen, device=cuda)
    out = fa.flash_attention(q, k, k, causal=True)
    assert torch.equal(out[:, :, 0], torch.zeros_like(out[:, :, 0]))
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, k), rtol=2e-3, atol=2e-3)
    k = torch.randn(1, 2, 4096, dh, generator=gen, device=cuda)
    assert fa.decode_plan(1, 2, 8, 4096, dh, fa._sm_count(0))[2] > 1
    out = fa.flash_attention(q, k, k, causal=True, window=1)
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, k, window=1), rtol=2e-3,
                               atol=2e-3)
    empty = torch.zeros(1, 2, 0, dh, device=cuda)
    before = fa.DECODE_LAUNCHES
    out = fa.flash_attention(q[:, :, :1], empty, empty)
    assert fa.DECODE_LAUNCHES == before + 1
    assert torch.equal(out, torch.zeros_like(out))


# the float32 paths' new forms: MLA's layer forward and zamba2's on the mid
# tile (the latter at its own (80, 80)), at the path shapes and ragged ones
MID_CASES = [(1, 128, 128, 64, 64, 192, 128, 0), (2, 32, 32, 64, 64, 80, 80, 4096),
             (1, 128, 128, 61, 75, 192, 128, 0), (2, 32, 32, 70, 70, 80, 80, 5),
             (3, 48, 24, 33, 40, 80, 80, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", MID_CASES, ids=lambda c: "x".join(map(str, c)))
def test_cuda_tile_mid_form_matches_plain_and_model(cuda, case):
    """The tile route's mid form (32 rows over 32-key tiles, 128 threads)
    where the plan picks it: within 2e-3 of the plain version and 1e-5 of
    its CPU model (``ref.flash_attention_tile_ref`` at the plan's tiles),
    the same bits twice and with the log-sum-exp, and the rows with no key
    (Lq > Lk under causal) exactly 0."""
    b, h, hkv, lq, lk, dqk, dv, window = case
    gen = torch.Generator(device=cuda).manual_seed(sum(case))
    q = torch.randn(b, h, lq, dqk, generator=gen, device=cuda)
    k = torch.randn(b, hkv, lk, dqk, generator=gen, device=cuda)
    v = torch.randn(b, hkv, lk, dv, generator=gen, device=cuda)
    assert fa.kernel_widths("cuda_core", dqk, dv) == (dqk, dv)
    bm, bn, _ = fa.tile_plan(b, hkv, h // hkv * lq, dqk, fa._sm_count(0))
    assert fa.plan_form(dqk, bm) == "mid"
    before = fa_launches()
    got = fa.flash_attention(q, k, v, True, window)
    assert fa_launches() == (before[0] + 1, before[1], before[2])
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, True, window), rtol=2e-3,
                               atol=2e-3)
    model = ref.flash_attention_tile_ref(q, k, v, True, window, bm=bm, bn=bn)
    torch.testing.assert_close(got, model, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, fa.flash_attention(q, k, v, True, window))
    assert torch.equal(got, fa._launch("cuda_core", q, k, v, True, window, with_lse=True)[0])
    if lq > lk:
        assert torch.equal(got[:, :, :lq - lk], torch.zeros_like(got[:, :, :lq - lk]))


@pytest.mark.gpu
@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("causal,window", TILE_MASKS)
def test_cuda_tile_route_at_80_matches_plain(cuda, small, causal, window):
    """hubert's and zamba2's width 80 at its own instantiation (rows padded
    to 21 chunks in shared memory, 5 output dims a thread), under the large
    and the small tile, rows ragged around both, q, k and v read in place
    from [B, L, H, Dh]: within 2e-3 of the plain version, the same bits
    twice and with the log-sum-exp."""
    gen = torch.Generator(device=cuda).manual_seed(80 + 2 * small)
    form = "small" if small else "large"
    bm = fa.tile_shape(80, form)[0]
    b, hkv = (1, 2) if small else (33, 4)
    assert fa.kernel_widths("cuda_core", 80, 80) == (80, 80)
    for lq, lk in [(2 * bm - 1, 2 * bm + 20), (2 * bm + 1, 2 * bm + 1)]:
        assert fa.tile_plan(b, hkv, lq, 80, fa._sm_count(0))[0] == bm
        x = torch.randn(b, lq, hkv, 80, generator=gen, device=cuda)
        ck, cv = (torch.randn(b, lk + 3, hkv, 80, generator=gen, device=cuda) for _ in range(2))
        q, k, v = x.transpose(1, 2), ck[:, :lk].transpose(1, 2), cv[:, :lk].transpose(1, 2)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, causal, window),
                                   rtol=2e-3, atol=2e-3)
        assert torch.equal(got, fa.flash_attention(q, k, v, causal=causal, window=window))
        assert torch.equal(got, fa._launch("cuda_core", q, k, v, causal, window,
                                           with_lse=True)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("lk", [4096, 3001, 300])
def test_cuda_decode_ring_step_matches_plain_and_model(cuda, lk):
    """h2o-danube's ring step (q [1, 32, 1, 120] over 8 kv heads) over the
    [B, buf, Hkv, Dh] ring read in place, at its 4,096 slots (16 splits of
    256 keys, 4 rows a block) and ragged lengths: within 2e-3 of the plain
    version and 1e-5 of its CPU model (``ref.flash_attention_split_ref`` at
    the wrapper's plan), the same bits twice, one launch; a window of one
    key (every split but one holds none of a row's keys) matches the plain
    version; the counters are all 0 after the call."""
    gen = torch.Generator(device=cuda).manual_seed(lk)
    ring_k, ring_v = (torch.randn(1, lk, 8, 120, generator=gen, device=cuda) for _ in range(2))
    k, v = ring_k.transpose(1, 2), ring_v.transpose(1, 2)
    q = torch.randn(1, 1, 32, 120, generator=gen, device=cuda).transpose(1, 2)
    assert fa._aligned(k) is k and fa._aligned(v) is v
    r, _, n, chunk = fa.decode_plan(1, 8, 4, lk, 128, fa._sm_count(0))
    if lk == 4096:
        assert (r, n, chunk) == (4, 16, 256)
    before = fa.DECODE_LAUNCHES
    got = fa.flash_attention(q, k, v)
    assert fa.DECODE_LAUNCHES == before + 1
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v), rtol=2e-3, atol=2e-3)
    _, teams, unit = fa.decode_layout(128)
    model = ref.flash_attention_split_ref(q, k, v, n_splits=n, chunk=chunk, teams=teams,
                                          unit=unit)
    torch.testing.assert_close(got, model, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, fa.flash_attention(q, k, v))
    one = fa.flash_attention(q, k, v, window=1)
    torch.testing.assert_close(one, ref.flash_attention_ref(q, k, v, window=1), rtol=2e-3,
                               atol=2e-3)
    torch.cuda.synchronize()
    assert all(int(c.count_nonzero()) == 0 for c in fa._COUNTERS.values())


@pytest.mark.gpu
@pytest.mark.parametrize("lk", [64, 37, 1])
def test_cuda_decode_zamba2_step_at_80(cuda, lk):
    """zamba2's step (q [2, 32, 1, 80] over its ring, one split) at its own
    (80, 80) instantiation: within 2e-3 of the plain version and 1e-5 of
    the CPU model, the same bits twice; a query before every key (Lq 2 over
    one key, causal) comes out 0 in its first row."""
    gen = torch.Generator(device=cuda).manual_seed(lk + 80)
    ck, cv = (torch.randn(2, lk, 32, 80, generator=gen, device=cuda) for _ in range(2))
    k, v = ck.transpose(1, 2), cv.transpose(1, 2)
    q = torch.randn(2, 1, 32, 80, generator=gen, device=cuda).transpose(1, 2)
    assert fa.kernel_widths("decode", 80, 80) == (80, 80)
    got = fa.flash_attention(q, k, v, window=4096)
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, window=4096), rtol=2e-3,
                               atol=2e-3)
    _, _, n, chunk = fa.decode_plan(2, 32, 1, lk, 80, fa._sm_count(0))
    _, teams, unit = fa.decode_layout(80)
    model = ref.flash_attention_split_ref(q, k, v, True, 4096, n_splits=n, chunk=chunk,
                                          teams=teams, unit=unit)
    torch.testing.assert_close(got, model, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, fa.flash_attention(q, k, v, window=4096))
    q2 = torch.randn(2, 32, 2, 80, generator=gen, device=cuda)
    out = fa.flash_attention(q2, k[:, :, :1], v[:, :, :1])
    assert torch.equal(out[:, :, 0], torch.zeros_like(out[:, :, 0]))


@pytest.mark.gpu
@pytest.mark.parametrize("lk", [32, 4096])
def test_cuda_decode_route_gives_the_same_bits_twice(cuda, lk):
    """No atomics, and the splits and teams fold in a fixed order: a
    second call repeats the first, with one split and with many."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn(4, 64, 1, 128, generator=gen, device=cuda)
    k, v = (torch.randn(4, 8, lk, 128, generator=gen, device=cuda) for _ in range(2))
    assert (fa.decode_plan(4, 8, 8, lk, 128, fa._sm_count(0))[2] > 1) == (lk > 32)
    assert torch.equal(fa.flash_attention(q, k, v), fa.flash_attention(q, k, v))


@pytest.mark.gpu
def test_cuda_decode_launches_count_once_a_call(cuda):
    """DECODE_LAUNCHES goes up by exactly one a call, whether the call ran
    one split or several (whose last block folds them); the tile route and
    bfloat16 leave it alone."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    q = torch.randn(1, 4, 1, 64, generator=gen, device=cuda)
    for lk in (5, 300, 5000):
        k = torch.randn(1, 2, lk, 64, generator=gen, device=cuda)
        before = (fa.LAUNCHES, fa.DECODE_LAUNCHES)
        fa.flash_attention(q, k, k)
        assert (fa.LAUNCHES, fa.DECODE_LAUNCHES) == (before[0] + 1, before[1] + 1)
    before = (fa.LAUNCHES, fa.DECODE_LAUNCHES)
    fa.flash_attention(torch.randn(1, 4, 64, 64, device=cuda), k, k)
    fa.flash_attention(q.bfloat16(), k.bfloat16(), k.bfloat16())
    assert (fa.LAUNCHES, fa.DECODE_LAUNCHES) == (before[0] + 2, before[1])


@pytest.mark.gpu
def test_cuda_qwen3_decode_step_takes_the_decode_route(cuda):
    """qwen3-0.6b's smoke model in float32: each decode step runs one
    decode-route launch a layer, the 16-token forward one tile-route
    launch a layer, and every step's logits stay within 2e-3 * scale of
    the forward's."""
    model = _smoke_model("qwen3-0.6b", torch.float32, cuda, seed=1)
    n_layers = model.cfg.n_layers
    toks = torch.randint(0, model.cfg.vocab_size, (2, 16), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(2))
    before = (fa.LAUNCHES, fa.DECODE_LAUNCHES)
    full, _ = model.forward(toks)
    assert (fa.LAUNCHES, fa.DECODE_LAUNCHES) == (before[0] + n_layers, before[1])
    cache = model.init_cache(2, 16)
    for t in range(16):
        before = (fa.LAUNCHES, fa.DECODE_LAUNCHES)
        lg, cache = model.decode_step(cache, toks[:, t:t + 1])
        assert (fa.LAUNCHES, fa.DECODE_LAUNCHES) == (before[0] + n_layers,
                                                     before[1] + n_layers)
        err = float((lg[:, 0] - full[:, t]).abs().max())
        assert err < 2e-3 * max(float(full[:, t].abs().max()), 1.0), (t, err)


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
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "kimi-k2-1t-a32b", "deepseek-v2-236b",
                                  "h2o-danube-3-4b"])
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
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "h2o-danube-3-4b", "qwen2-vl-2b",
                                  "hubert-xlarge"])
def test_cuda_lm_families_match_cpu(cuda, arch):
    """MLA (the kernel at (48, 32) for the prefill and (80, 64) over the
    latent for the decode), the sliding window's ring (40 steps into a
    40-slot cache wrap its 32-slot ring), M-RoPE on embeddings, and
    hubert's bidirectional encoder: the same weights on the card (kernels)
    and on the CPU (plain versions) give the same forward logits and the
    same logits at every decode step, float32."""
    cpu = _smoke_model(arch, torch.float32, "cpu")
    cfg = cpu.cfg
    gpu = Model(cfg, dtype=torch.float32, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(4)
    s = 40
    if cfg.frontend != "none":
        x = torch.randn(2, s, cfg.d_model, generator=gen)
        fwd = {"embeds": x}
    else:
        x = torch.randint(0, cfg.vocab_size, (2, s), generator=gen)
        fwd = {"tokens": x}
    before = fa.LAUNCHES
    want, _ = cpu.forward(**fwd)
    got, _ = gpu.forward(**{k: t.to(cuda) for k, t in fwd.items()})
    assert fa.LAUNCHES == before + cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    if not cfg.has_decoder:
        return
    cache_c, cache_g = cpu.init_cache(2, s), gpu.init_cache(2, s)
    for t in range(s):
        want_t, cache_c = cpu.decode_step(cache_c, x[:, t:t + 1])
        got_t, cache_g = gpu.decode_step(cache_g, x[:, t:t + 1].to(cuda))
        scale = max(1.0, float(want_t.abs().max()))
        assert float((got_t.cpu() - want_t).abs().max()) <= 1e-4 * scale, (arch, t)
    assert fa.DECODE_LAUNCHES > 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m"])
def test_cuda_ssm_families_match_cpu(cuda, arch):
    """zamba2 (Mamba2 groups, the one shared attention block and its ring:
    40 steps wrap each group's 32-slot ring) and xLSTM (mLSTM and sLSTM):
    the same weights on the card (zamba2's attention on the kernels) and on
    the CPU (plain versions) give the same forward logits and the same
    logits at every decode step, float32, and each decode step agrees with
    the card's own forward within tests/test_models.py's 2e-3 * scale. A
    zamba2 forward and a decode step launch one attention a group; xLSTM
    launches none."""
    cpu = _smoke_model(arch, torch.float32, "cpu")
    cfg = cpu.cfg
    gpu = Model(cfg, dtype=torch.float32, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    groups = cfg.n_layers // cfg.attn_every if cfg.ssm else 0
    s = 40
    x = torch.randint(0, cfg.vocab_size, (2, s), generator=torch.Generator().manual_seed(4))
    before = (fa.LAUNCHES, fa.DECODE_LAUNCHES)
    want, _ = cpu.forward(x)
    got, _ = gpu.forward(x.to(cuda))
    assert fa.LAUNCHES == before[0] + groups
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    cache_c, cache_g = cpu.init_cache(2, s), gpu.init_cache(2, s)
    for t in range(s):
        want_t, cache_c = cpu.decode_step(cache_c, x[:, t:t + 1])
        got_t, cache_g = gpu.decode_step(cache_g, x[:, t:t + 1].to(cuda))
        scale = max(1.0, float(want_t.abs().max()))
        assert float((got_t.cpu() - want_t).abs().max()) <= 1e-4 * scale, (arch, t)
        own = max(1.0, float(got[:, t].abs().max()))
        assert float((got_t[:, 0] - got[:, t]).abs().max()) <= 2e-3 * own, (arch, t)
    assert fa.LAUNCHES == before[0] + groups * (1 + s)
    assert fa.DECODE_LAUNCHES == before[1] + groups * s


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m"])
def test_cuda_ssm_families_generate_is_deterministic(cuda, arch):
    """Two bf16 generate runs give the same tokens; zamba2's attention takes
    the tensor-core kernel, one launch a group a step."""
    model = _smoke_model(arch, torch.bfloat16, cuda)
    cfg = model.cfg
    prompts = torch.randint(0, cfg.vocab_size, (4, 8), device=cuda,
                            generator=torch.Generator(device=cuda).manual_seed(5))
    before = fa.SM90_LAUNCHES
    a = serve.generate(model, prompts, 8)
    b = serve.generate(model, prompts, 8)
    assert torch.equal(a, b)
    groups = cfg.n_layers // cfg.attn_every if cfg.ssm else 0
    assert fa.SM90_LAUNCHES == before + 2 * 16 * groups


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


# --------------------------------------------------------------------------
# streaming updates: refreshed bindings on the card
# --------------------------------------------------------------------------


STREAM_PROGRAMS = [("BFS_ECP", {"root": 0}, False), ("SSSP", {"root": 0}, True),
                   ("WCC", {}, False)]


def _stream_graph(weighted: bool):
    """A small skewed graph padded to its bucket plus 3 x SPLIT_LEN more
    slots: the padding self-loops form one bin the work list splits, and
    every delta moves it."""
    g = generators.rmat(11, 16, seed=3, weighted=weighted)
    shape = repro_torch.GraphShape.bucket_for(g.n_vertices, g.n_edges, weighted=weighted)
    return g.pad_to(shape.n_vertices, shape.n_edges + 3 * L)


def _equal_bindings(engine, fresh):
    for key, want in fresh.gb.items():
        got = engine.gb[key]
        if isinstance(want, torch.Tensor):
            assert torch.equal(got, want), key
        elif isinstance(want, tuple) and all(isinstance(t, torch.Tensor) for t in want):
            assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True)), key
        else:
            assert got == want, key
    for key, want in fresh._initial.items():
        assert torch.equal(engine._initial[key], want), key


@pytest.mark.gpu
@pytest.mark.parametrize("name,params,weighted", STREAM_PROGRAMS)
def test_cuda_streaming_repair_equals_a_full_run_on_the_card(cuda, name, params, weighted):
    """Three additions-only deltas of 2 x SPLIT_LEN edges each: every query
    is a host repair, equal bit for bit to a full run on the card through
    the refreshed bindings (whose every tensor, the work list included,
    equals a fresh bind's) and to the CPU's run on the same graph."""
    g = _stream_graph(weighted)
    prog = repro_torch.compile(getattr(sources, name))
    acc = prog.lower(graph=g, device=cuda)
    ss = repro_torch.StreamingSession(prog, g, accelerator=acc)
    rng = np.random.default_rng(7)
    try:
        ss.run(**params)
        splits = []
        sr.LAUNCHES, es.LAUNCHES = 0, 0
        for _ in range(3):
            edges = rng.integers(0, g.n_vertices_logical, size=(2 * L, 2)).astype(np.int32)
            w = rng.integers(1, 64, size=2 * L).astype(np.float32) if weighted else None
            ss.update(repro_torch.GraphDelta(added_edges=edges, added_weights=w))
            repaired = ss.run(**params)
            warm = set(acc.library.warm_keys)
            full = ss.session.run(**params)
            new = set(acc.library.warm_keys) - warm  # a frontier pad touched first now
            assert not any(k[0] == "full" for k in new), new
            assert (full.stats.compile_time_s == 0.0) == (not new), new
            for prop, a in full.properties.items():
                b = repaired.properties[prop]
                assert a.dtype == b.dtype and np.array_equal(a, b), prop
            assert repaired.host_env == full.host_env and repaired.version == ss.version
            cpu = prog.bind(ss.graph, device="cpu").run(**params)
            for prop, a in cpu.properties.items():
                assert np.array_equal(a, full.properties[prop]), prop
            _equal_bindings(ss.session.engine, acc.bind(ss.graph).engine)
            splits.append(int(ss.session.engine.gb["es_split"].chunks.shape[0]))
        assert ss.incremental_runs == 3
        # WCC's edge kernel writes both endpoints: it commits through
        # shuffle_reduce alone
        assert sr.LAUNCHES > 0 and (es.LAUNCHES > 0) == (name != "WCC"), \
            (sr.LAUNCHES, es.LAUNCHES)
        assert len(set(splits)) > 1, splits  # the padding bin's chunks moved
    finally:
        ss.close()


@pytest.mark.gpu
def test_cuda_streaming_pool_concurrent_updates(cuda):
    """A pool of two sessions on the card answers queries while updates
    land: every result is pinned to a version, and once quiet the current
    answer equals a fresh bind's."""
    import threading

    g = _stream_graph(False)
    prog = repro_torch.compile(sources.BFS_ECP)
    ss = repro_torch.StreamingSession(prog, g, pool_size=2, compact_every=0, device=cuda)
    rng = np.random.default_rng(3)
    errors, done = [], threading.Event()
    try:
        ss.warmup(root=0)

        def updater():
            try:
                for _ in range(4):
                    e = rng.integers(0, g.n_vertices_logical, size=(64, 2)).astype(np.int32)
                    ss.update(repro_torch.GraphDelta(added_edges=e))
            except Exception as exc:  # pragma: no cover
                errors.append(exc)
            finally:
                done.set()

        t = threading.Thread(target=updater)
        t.start()
        futures = []
        while not done.is_set():
            futures.extend(ss.submit(root=r % 5) for r in range(4))
            for f in futures[-4:]:
                f.result()
        t.join()
        assert not errors, errors
        assert {f.result().version for f in futures} <= set(range(ss.version + 1))
        got = ss.run(root=1)
        want = prog.bind(ss.graph, device=cuda).run(root=1)
        for prop, a in want.properties.items():
            assert np.array_equal(a, got.properties[prop]), prop
        assert ss.updates == 4
    finally:
        ss.close()


# --------------------------------------------------------------------------
# serving and autotune on the card
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("name,params,weighted", [
    ("bfs", [{"root": r} for r in range(12)], False),
    ("sssp", [{"root": r} for r in range(6)], True),
    ("pagerank", [{"iters": 5}, {"iters": 8}], False),
])
def test_cuda_served_batches_equal_a_session(cuda, tmp_path, name, params, weighted):
    """A service on the card (two workers, batches of up to 8) answers as a
    session of the same parameters does, bit for bit, through the graph
    kernels; its entry binds the graph once for single and batched
    requests."""
    from repro_torch.serving import NAMED_ALGORITHMS

    g = generators.rmat(11, 16, seed=5, weighted=weighted)
    session = repro_torch.compile(NAMED_ALGORITHMS[name]).bind(g, device=cuda)
    want = [session.run(**p) for p in params]
    with repro_torch.serve(str(tmp_path), device=cuda, workers=2, max_batch=8) as svc:
        svc.run(name, g, **params[0])  # lower and bind before counting
        sr.LAUNCHES, es.LAUNCHES = 0, 0
        futs = [svc.submit(name, g, tenant="ab"[i % 2], **p) for i, p in enumerate(params)]
        got = [f.result(timeout=300) for f in futs]
        launches = (sr.LAUNCHES, es.LAUNCHES)
        (entry,) = svc.registry._residents.values()
        assert entry.accelerator.binds == 1 and entry.session.device.startswith("cuda")
        if len(params) > 2:
            assert svc.stats()["batches"]["batches"] < len(params) + 1
    assert launches[0] + launches[1] > 0 and launches[1] > 0, launches
    for a, b in zip(want, got):
        for prop, x in a.properties.items():
            assert x.dtype == b.properties[prop].dtype and np.array_equal(x, b.properties[prop])


@pytest.mark.gpu
def test_cuda_autotune_small_search(cuda, tmp_path):
    """A short search on the card: the winner is never slower than the
    baseline referee, a fresh tuner on the same cache makes no trial, and
    the tuned lowering answers as the default target does."""
    from repro_torch.autotune import AutoTuner, TuningCache, tuning_dir_for

    g = generators.rmat(11, 16, seed=5)
    prog = repro_torch.compile(sources.BFS_ECP)
    cache = TuningCache(tuning_dir_for(str(tmp_path)))
    report = AutoTuner(cache, reps=2, max_candidates=3, device=cuda).tune(
        prog, g, params={"root": 0})
    assert not report.cache_hit and report.trials >= 2
    assert report.config.objective_s <= report.config.baseline_s * 1.0001
    again = AutoTuner(TuningCache(tuning_dir_for(str(tmp_path))), device=cuda).tune(
        prog, g, params={"root": 0})
    assert again.cache_hit and again.trials == 0
    acc = prog.lower(graph=g, tuned=True, tuning_cache=cache, device=cuda)
    assert acc.tuned == report.config.to_dict()
    got = acc.bind(g).run(root=7).properties["old_level"]
    assert np.array_equal(got, prog.bind(g, device=cuda).run(root=7).properties["old_level"])


# ---------------------------------------------------------------------------
# the distributed engine: shards on the card
# ---------------------------------------------------------------------------


def _dist_target(n):
    return repro_torch.Target(kind="distributed", n_devices=n)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_cuda_superstep_matches_plain_on_the_cpu(cuda, dtype):
    """A superstep at D = 4 on the card equals the same superstep on the
    CPU (the plain shuffle_reduce): bit for bit for min, and for + on
    integer-valued inputs, whose every summation order is exact."""
    from repro_torch.core.dist_engine import make_push_step, partition_graph

    g = generators.rmat(12, 16, seed=3, weighted=True)
    mesh = _dist_target(4).mesh(cuda)
    on_card, on_cpu = partition_graph(g, mesh), partition_graph(g, ["cpu"] * 4)
    gen = np.random.default_rng(1)
    prop = torch.from_numpy(gen.integers(0, 50, g.n_vertices)).to(dtype)
    for op, fn in (("min", lambda sv, w: sv + w.to(sv.dtype)), ("+", lambda sv, w: sv)):
        before = sr.LAUNCHES
        got = make_push_step(on_card, fn, op)(prop.to(cuda))
        assert sr.LAUNCHES == before + 4  # one shuffle_reduce per destination owner
        want = make_push_step(on_cpu, fn, op)(prop)
        assert got.dtype == want.dtype and torch.equal(got.cpu(), want), op


@pytest.mark.gpu
def test_cuda_superstep_launches_shuffle_reduce_once_per_shard(cuda):
    """Distributed PAGERANK on the card: every superstep launches
    shuffle_reduce once per shard and edge_stream never (its only edge
    kernel distributes); its ranks meet the single-device run's."""
    g = generators.rmat(12, 16, seed=3)
    prog = repro_torch.compile(sources.PAGERANK)
    want = prog.bind(g, device=cuda).run(iters=3)
    for d in (1, 4):
        sess = prog.bind(g, device=cuda, target=_dist_target(d))
        sess.run(iters=3)
        sr.LAUNCHES, es.LAUNCHES = 0, 0
        got = sess.run(iters=3)
        assert got.stats.dist_supersteps == 3
        assert (sr.LAUNCHES, es.LAUNCHES) == (3 * d, 0), (d, sr.LAUNCHES, es.LAUNCHES)
        np.testing.assert_allclose(got.properties["rank"], want.properties["rank"],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_cuda_shards_are_placed_by_the_modulo(cuda):
    """Twice as many shards as cards: shard k lives on cuda:{k % count},
    and BFS_ECP and SSSP are the single-device run's bits."""
    count = torch.cuda.device_count()
    target = _dist_target(2 * count)
    mesh = target.mesh(cuda)
    assert mesh == [f"cuda:{k % count}" for k in range(2 * count)]
    g = generators.rmat(12, 16, seed=3, weighted=True)
    for name, prop in (("BFS_ECP", "old_level"), ("SSSP", "SP")):
        prog = repro_torch.compile(getattr(sources, name))
        sess = prog.bind(g, device=cuda, target=target)
        got = sess.run(root=0)
        dg = sess.engine._dist_graph
        for k, dev in enumerate(mesh):
            assert dg.src_local[k].device == torch.device(dev)
            assert dg.recv_perm[k].device == torch.device(dev)
        want = prog.bind(g, device=cuda).run(root=0)
        assert got.stats.dist_supersteps > 0
        assert np.array_equal(got.properties[prop], want.properties[prop]), name


@pytest.mark.gpu
def test_cuda_warm_pagerank_iteration_reads_nothing_back(cuda):
    """One warm distributed PAGERANK iteration (a superstep and the vertex
    stage) under ``set_sync_debug_mode("error")``: the segment sizes are
    known at partition time, so nothing is read back to the host."""
    g = generators.rmat(12, 16, seed=3)
    sess = repro_torch.compile(sources.PAGERANK).bind(g, device=cuda, target=_dist_target(4))
    sess.run(iters=2)
    eng = sess.engine
    pipe = next(k for k in eng.module.kernels if "__" in k)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.launch(pipe)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert eng.stats.dist_supersteps >= 1


@pytest.mark.gpu
@pytest.mark.parametrize("algo", sorted(ALGORITHMS))
def test_cuda_distributed_programs_match_cpu(cuda, algo):
    """Every program on the distributed target at D = 4 on the card meets
    the parity contract against the same target on the CPU; supersteps
    and launches are equal."""
    name, params = ALGORITHMS[algo]
    g = generators.power_law(400, 3000, seed=5, weighted=True)
    prog = repro_torch.compile(getattr(sources, name))
    target = _dist_target(4)
    got = prog.bind(g, device=cuda, target=target).run(**params)
    want = prog.bind(g, device="cpu", target=target).run(**params)
    for prop, a in want.properties.items():
        b = got.properties[prop]
        if algo in FLOAT_SUMS and a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=prop)
        else:
            np.testing.assert_array_equal(b, a, err_msg=prop)
    assert got.host_env == want.host_env
    assert got.stats.kernel_launches == want.stats.kernel_launches
    assert got.stats.dist_supersteps == want.stats.dist_supersteps


# ---------------------------------------------------------------------------
# training: the backward kernels and the train step on the card
# ---------------------------------------------------------------------------

# (b, h, hkv, lq, lk, dqk, dv, causal, window): GQA, ragged 64-row/key
# tiles, a window that hides keys, bidirectional, Dv < Dqk (MLA, and the
# smoke MLA's (48, 32)), rows with no key (Lq > Lk), a decode-shaped row
BWD_SHAPES = [(2, 4, 2, 64, 64, 32, 32, True, 0), (1, 4, 1, 100, 100, 64, 64, True, 0),
              (2, 6, 2, 130, 130, 128, 128, True, 0), (1, 4, 4, 65, 200, 80, 80, True, 48),
              (1, 2, 2, 70, 70, 80, 80, False, 0), (1, 4, 4, 96, 96, 192, 128, True, 0),
              (1, 2, 1, 40, 10, 48, 32, True, 0), (1, 4, 2, 1, 77, 128, 128, True, 0),
              (2, 2, 2, 33, 129, 120, 120, True, 0)]
# bf16 gradients against the float32 plain twin: max over rows of max |err|
# / max(rms(row), GRAD_ROW_FLOOR * rms(tensor)); the floor keeps a row whose
# gradient cancels to rounding noise (a query that sees one key) from
# dividing by that noise
GRAD_ROW_FLOOR = 1e-2


def _grad_row_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(dim=-1).sqrt()
    floor = GRAD_ROW_FLOOR * w.pow(2).mean().sqrt()
    return float(((g - w).abs().amax(dim=-1) / torch.maximum(rms, floor).clamp_min(1e-30)).max())


def _bwd_inputs(shape, dtype, dev, seed=0):
    b, h, hkv, lq, lk, dqk, dv, causal, window = shape
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q, k = torch.randn(b, h, lq, dqk, generator=gen), torch.randn(b, hkv, lk, dqk, generator=gen)
    v, dout = torch.randn(b, hkv, lk, dv, generator=gen), torch.randn(b, h, lq, dv, generator=gen)
    q, k, v, dout = (t.to(dev, dtype) for t in (q, k, v, dout))
    out = fa.flash_attention(q, k, v, causal, window)
    return q, k, v, out, dout, causal, window


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "x".join(map(str, s[:7])) +
                         ("-causal" if s[7] else "-bidir") + (f"-w{s[8]}" if s[8] else ""))
def test_cuda_flash_attention_bwd_matches_plain(cuda, shape, dtype):
    """The backward kernels against the plain twin on the card, at every
    width of both tables (80, 120 and (48, 32) rounded up): float32
    (csrc/flash_attention_bwd.cu) within 1e-4 of the gradient's scale,
    bfloat16 (csrc/flash_attention_bwd_sm90.cu, the forward run first for
    its lse) by the row-relative rule; the same bits on two calls; one
    backward launch a call."""
    q, k, v, out, dout, causal, window = _bwd_inputs(shape, dtype, cuda)
    before = fa.BWD_LAUNCHES
    got = fa.flash_attention_bwd(q, k, v, out, dout, causal, window)
    again = fa.flash_attention_bwd(q, k, v, out, dout, causal, window)
    assert fa.BWD_LAUNCHES - before == 2
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), out.float(),
                                       dout.float(), causal, window)
    for name, a, b, w, x in zip("qkv", got, again, want, (q, k, v)):
        assert a.shape == x.shape and a.dtype == dtype and torch.equal(a, b), name
        assert torch.isfinite(a).all(), name
        if dtype == torch.float32:
            tol = 1e-4 * max(1.0, float(w.abs().max()))
            assert float((a - w).abs().max()) <= tol, name
        else:
            assert _grad_row_rel(a, w) <= SM90_ROW_REL_TOL, name


#: sha256 of (dq, dk, dv) of the float32 backward at BWD_SHAPES[2] (seed
#: 0), as csrc/flash_attention_bwd.cu gives them since its redesign (the
#: forward's lse, register-blocked tiles; H100 80GB HBM3): a change that
#: moves its bits must say so here
F32_BWD_DIGEST = "f90437b108bfbaa9ab2bd6ed0c6bdc23537bbfd404e61257a6ee1e5ea9dcfe7b"


@pytest.mark.gpu
def test_cuda_flash_attention_bwd_f32_keeps_its_bits(cuda):
    """The float32 backward gives the bits pinned for its summation order,
    twice."""
    import hashlib

    q, k, v, out, dout, causal, window = _bwd_inputs(BWD_SHAPES[2], torch.float32, cuda)
    digests = []
    for _ in range(2):
        h = hashlib.sha256()
        for g in fa.flash_attention_bwd(q, k, v, out, dout, causal, window):
            h.update(g.cpu().numpy().tobytes())
        digests.append(h.hexdigest())
    assert digests == [F32_BWD_DIGEST] * 2


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "x".join(map(str, s[:7])) +
                         ("-causal" if s[7] else "-bidir") + (f"-w{s[8]}" if s[8] else ""))
def test_cuda_flash_attention_bwd_f32_follows_its_schedule(cuda, shape):
    """The float32 backward (csrc/flash_attention_bwd.cu) given the tile
    route's lse, at every instantiation: within 1e-4 of the plain twin's
    scale, the same bits twice and as a call that runs the forward for its
    lse, and within 2e-5 of its schedule's model
    (ref.flash_attention_bwd_simt_ref at the source's tiles: the same sums
    in the same tile order, each tile's own sum in another order)."""
    b, h, hkv, lq, lk, dqk, dv, causal, window = shape
    q, k, v, out, dout, _, _ = _bwd_inputs(shape, torch.float32, cuda)
    scale = 1.0 / math.sqrt(dqk)
    out, lse = fa._launch("cuda_core", q, k, v, causal, window, scale, with_lse=True)
    got = fa.flash_attention_bwd(q, k, v, out, dout, causal, window, lse=lse)
    again = fa.flash_attention_bwd(q, k, v, out, dout, causal, window)
    keys, rows = fa.bwd_tiles(fa.bwd_widths(dqk, dv, torch.float32)[0])
    model = ref.flash_attention_bwd_simt_ref(q, k, v, out, dout, lse, causal, window,
                                             keys=keys, rows=rows)
    want = ref.flash_attention_bwd_ref(q, k, v, out, dout, causal, window)
    for name, a, b_, m, w in zip("qkv", got, again, model, want):
        assert torch.equal(a, b_), name
        g = max(1.0, float(w.abs().max()))
        assert float((a - w).abs().max()) <= 1e-4 * g, name
        assert float((a - m).abs().max()) <= 2e-5 * g, name


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "x".join(map(str, s[:7])) +
                         ("-causal" if s[7] else "-bidir") + (f"-w{s[8]}" if s[8] else ""))
def test_cuda_f32_tile_route_lse_keeps_output_bits(cuda, shape):
    """The float32 tile route asked for its log-sum-exp writes the same
    output bits as without it, in both of its tiles; the lse is the plain
    one (log2 domain) within float32 rounding, +inf for a row with no key."""
    b, h, hkv, lq, lk, dqk, dv, causal, window = shape
    q, k, v, _, _, _, _ = _bwd_inputs(shape, torch.float32, cuda)
    scale = 1.0 / math.sqrt(dqk)
    plain_out = fa._launch("cuda_core", q, k, v, causal, window, scale)
    out, lse = fa._launch("cuda_core", q, k, v, causal, window, scale, with_lse=True)
    assert torch.equal(out, plain_out)
    assert lse.shape == (b, h, lq) and lse.dtype == torch.float32
    want = ref.attention_lse_ref(q, k, causal, window)
    live = torch.isfinite(want)
    assert torch.equal(torch.isfinite(lse), live) and bool((lse[~live] == math.inf).all())
    if bool(live.any()):
        err = float((lse[live] - want[live]).abs().max())
        assert err <= 1e-5 * max(1.0, float(want[live].abs().max())), err


@pytest.mark.gpu
@pytest.mark.parametrize("lq", [200, 1])
def test_cuda_flash_attention_fn_f32_saves_lse(cuda, lq):
    """FlashAttentionFn in float32: on the tile route the forward writes
    its lse and the backward takes it (one forward launch, one backward);
    a decode-route forward (one query row) saves none, so the backward
    first runs the tile route for it. The gradients equal the plain
    twin's within 1e-4 of their scale."""
    gen = torch.Generator().manual_seed(5)
    base = [torch.randn(2, n, lq if n == 8 else 300, 64, generator=gen) for n in (8, 2, 2)]
    leaves = [t.to(cuda).requires_grad_(True) for t in base]
    fa.LAUNCHES, fa.DECODE_LAUNCHES, fa.BWD_LAUNCHES = 0, 0, 0
    out = fa.flash_attention(*leaves)
    dout = torch.randn(out.shape, generator=gen).to(cuda)
    out.backward(dout)
    decode = 1 if lq == 1 else 0
    assert (fa.LAUNCHES, fa.DECODE_LAUNCHES, fa.BWD_LAUNCHES) == (1 + decode, decode, 1)
    want = ref.flash_attention_bwd_ref(*(t.detach() for t in leaves), out.detach(), dout)
    for leaf, w in zip(leaves, want):
        assert float((leaf.grad - w).abs().max()) <= 1e-4 * max(1.0, float(w.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "x".join(map(str, s[:7])) +
                         ("-causal" if s[7] else "-bidir") + (f"-w{s[8]}" if s[8] else ""))
def test_cuda_flash_attention_forward_lse_keeps_output_bits(cuda, shape):
    """The bf16 forward asked for its log-sum-exp writes the same output
    bits as without it; the lse is the plain one (log2 domain) within
    float32 rounding of the hardware's exp2, +inf for a row with no key."""
    b, h, hkv, lq, lk, dqk, dv, causal, window = shape
    q, k, v, _, _, _, _ = _bwd_inputs(shape, torch.bfloat16, cuda)
    scale = 1.0 / math.sqrt(dqk)
    plain_out = fa._launch("sm90", q, k, v, causal, window, scale)
    out, lse = fa._launch("sm90", q, k, v, causal, window, scale, with_lse=True)
    assert torch.equal(out, plain_out)
    assert lse.shape == (b, h, lq) and lse.dtype == torch.float32
    want = ref.attention_lse_ref(q, k, causal, window)
    live = torch.isfinite(want)
    assert torch.equal(torch.isfinite(lse), live) and bool((lse[~live] == math.inf).all())
    if bool(live.any()):
        err = float((lse[live] - want[live]).abs().max())
        assert err <= 1e-5 * max(1.0, float(want[live].abs().max())), err


@pytest.mark.gpu
@pytest.mark.parametrize("hkv", [1, 2, 8])
def test_cuda_flash_attention_bwd_sm90_reads_strided_views(cuda, hkv):
    """The bf16 backward on [B, L, H, D] activations viewed as [B, H, L, D]
    (the model's layout) gives the bits it gives on contiguous copies, and
    the gradients come back in the views' layout."""
    gen = torch.Generator().manual_seed(hkv)
    h, lq, dqk = 8, 150, 128
    base = [torch.randn(2, lq, n, dqk, generator=gen) for n in (h, hkv, hkv, h)]
    q, k, v, dout = (t.to(cuda, torch.bfloat16).transpose(1, 2) for t in base)
    out, lse = fa._launch("sm90", q, k, v, True, 0, 1.0 / math.sqrt(dqk), with_lse=True)
    got = fa.flash_attention_bwd(q, k, v, out, dout, True, 0, lse=lse)
    flat = fa.flash_attention_bwd(*(t.contiguous() for t in (q, k, v, out, dout)), True, 0,
                                  lse=lse)
    for g, c, x in zip(got, flat, (q, k, v)):
        assert torch.equal(g, c) and g.stride() == x.stride()
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), out.float(),
                                       dout.float(), True, 0)
    for a, w in zip(got, want):
        assert _grad_row_rel(a, w) <= SM90_ROW_REL_TOL


@pytest.mark.gpu
def test_cuda_flash_attention_fn_bf16_saves_lse_and_checkpoints(cuda):
    """FlashAttentionFn in bf16: the backward takes the lse the forward
    saved (one sm90 launch a forward, none in the backward), and under
    torch.utils.checkpoint (non-reentrant, as the model's remat) it gives
    the same gradient bits as without, the forward run twice."""
    from torch.utils.checkpoint import checkpoint

    gen = torch.Generator().manual_seed(7)
    base = [torch.randn(2, 200, n, 128, generator=gen) for n in (8, 2, 2)]
    grads = {}
    for remat in (False, True):
        leaves = [t.to(cuda, torch.bfloat16).requires_grad_(True) for t in base]

        def attend(q, k, v):
            out = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
            return out.transpose(1, 2).float().pow(2).sum()

        fa.SM90_LAUNCHES, fa.BWD_LAUNCHES = 0, 0
        loss = checkpoint(attend, *leaves, use_reentrant=False) if remat else attend(*leaves)
        loss.backward()
        assert (fa.SM90_LAUNCHES, fa.BWD_LAUNCHES) == (2 if remat else 1, 1)
        grads[remat] = [t.grad for t in leaves]
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_flash_attention_autograd_through_views(cuda):
    """FlashAttentionFn on [B, L, H, D] activations viewed as [B, H, L, D]
    (the model's layout): the card's gradients equal the CPU's plain twin's
    within float32 rounding, in the leaves' own layout."""
    gen = torch.Generator().manual_seed(3)
    base = [torch.randn(2, 96, h, 64, generator=gen) for h in (8, 2, 2)]
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev, copy=True).requires_grad_(True) for t in base]
        out = fa.flash_attention(*(t.transpose(1, 2) for t in leaves), causal=True)
        (out.transpose(1, 2) ** 2).sum().backward()
        grads[dev] = [t.grad.cpu() for t in leaves]
    for a, b in zip(grads[cuda], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_rows", [True, False])
def test_cuda_moe_gather_bwd_matches_plain(cuda, dtype, with_rows):
    """The gather's transpose on the card: bit for bit its plain twin (the
    same float32 adds in slot order), twice, and the gradient autograd
    takes through MoeGatherFn."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    g, t, d, e, k = 4, 96, 200, 8, 2
    cap = 20
    top_e = torch.rand(g, t, e, generator=gen, device=cuda).topk(k, dim=-1).indices
    _, order, offsets, sizes = moe_mod.route(top_e, e, cap)
    offsets, sizes = offsets.to(torch.int32), sizes.to(torch.int32)
    rows = (order // k).to(torch.int32) if with_rows else None
    dout = torch.randn(g, e, cap, d, generator=gen, device=cuda).to(dtype)
    before = md.BWD_LAUNCHES
    got = md.moe_gather_bwd(dout, offsets, sizes, cap, t, rows)
    again = md.moe_gather_bwd(dout, offsets, sizes, cap, t, rows)
    assert md.BWD_LAUNCHES - before == 2
    want = ref.moe_gather_bwd_ref(dout, rows, offsets, sizes, cap, t)
    assert torch.equal(got, want) and torch.equal(got, again)
    x = torch.randn(g, t, d, generator=gen, device=cuda).to(dtype).requires_grad_(True)
    md.moe_gather(x, offsets, sizes, cap, rows).backward(dout)
    assert torch.equal(x.grad, want)


@pytest.mark.gpu
def test_cuda_train_step_matches_cpu(cuda):
    """Three float32 train steps of qwen3's smoke config (remat, two
    microbatches) on the card and on the CPU from the same weights: the
    losses agree within 1e-4 relative; each step launches 2 forward and 1
    backward attention kernels per layer and microbatch."""
    from repro_torch.data import SyntheticLM
    from repro_torch.train import OptConfig, init_state, make_train_step

    cfg = smoke_config("qwen3-0.6b")
    losses = {}
    for dev in ("cpu", cuda):
        model = Model(cfg, torch.float32, device=dev)
        model.load_state_dict(Model(cfg, torch.float32, device="cpu")
                              .init(torch.Generator().manual_seed(0)).state_dict())
        opt = OptConfig(lr=3e-3, warmup_steps=2, total_steps=10)
        state = init_state(dict(model.named_parameters()), opt)
        step = make_train_step(model, opt, n_microbatches=2)
        data = SyntheticLM(cfg, 64, 4, seed=0)
        fa.LAUNCHES, fa.BWD_LAUNCHES = 0, 0
        losses[dev] = []
        for i in range(3):
            batch = {key: torch.from_numpy(a).to(dev) for key, a in data.batch(i).items()}
            state, metrics = step(state, batch)
            losses[dev].append(float(metrics["loss"]))
        if dev == cuda:
            assert fa.BWD_LAUNCHES == 3 * 2 * cfg.n_layers
            assert fa.LAUNCHES == 2 * fa.BWD_LAUNCHES
    np.testing.assert_allclose(losses[cuda], losses["cpu"], rtol=1e-4)
