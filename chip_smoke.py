"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # R19 (rmat-19-32), the paper's graph size
    python3 chip_smoke.py --scale 12 # a quick run on a small RMAT graph

Phases (any failure raises and exits nonzero; no phase's error is caught):

1. Device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. Build: compiles every CUDA source of ``src/repro_torch/csrc`` at once
   (one ``nvcc`` each) and prints the build time and ``ptxas`` resources.
3. Kernels: holds each hand-written kernel against its plain PyTorch
   version on the card, at the reference test shapes and at the main
   path's own shape (the R19 graph's dst-sorted edge stream), checks that
   a float ``+`` gives the same bits on two runs, and times kernel, plain
   version and (where one exists) a single PyTorch library call with CUDA
   events. ``edge_stream`` runs with the work list the bind built (its
   longest bin, chunks, work items and build time are printed), gets its
   device time (both of its kernels) from profiler events, and is also
   held to its plain version on a skewed stream (one bin of 2^20 edges,
   bins around the chunk length, empty bins) under every dtype, apply and
   op.
   The LM kernels (flash attention, MoE gather) are held to theirs at the
   reference test shapes and at the LM path's shapes: Kimi-K2's decode
   attention over the KV cache and a prefill-size causal attention, its
   decode dispatch and a 4096-token prefill dispatch. Attention runs both
   routes the wrapper takes by dtype: float32 through the CUDA-core kernel,
   bfloat16 through the tensor-core (sm90) kernel. The decode-shaped rows
   also get their device time, read from profiler kernel events, beside
   the host-paced loop's time; so do both MoE gather rows.
4. Graph path: ``repro_torch.compile(src).bind(g).run(**params)`` on the
   card for BFS_ECP, PAGERANK and SSSP (one cold run, then five warm
   runs whose median is the warm time), each checked
   against an independent numpy/scipy oracle, with both graph kernels'
   launch counters set to 0 before and read after. One more warm run of
   each program under ``torch.profiler`` then shows where its time goes:
   the device's busy and idle share and the kernels that took the most
   time, and one more the device time of each ``shuffle_reduce`` launch by
   its shape (bins, updates), which shows what the one-bin counters cost.
   The graph sessions are freed after it.
5. LM path: ``launch.serve.generate`` on Kimi-K2 at full width with its
   depth cut to 2 layers (1 dense + 1 MoE, random weights from the seed,
   bf16), batch 4, prompt 16, generate 16 (the CLI defaults), twice,
   with the LM kernels' launch counters set to 0 before and read after:
   the two runs must give the same tokens and the logits must be finite.
   Then qwen3-0.6b at its full config in float32: decode logits at every
   prompt position must agree with the whole-sequence forward.
   Then qwen3-0.6b at its full config in bf16: one ``Model.forward`` over
   batch 4 x 2048 prompt tokens (wall time, device busy time and the
   tensor-core attention's share of it, launches, peak memory), after the
   kernel is held to its plain version at exactly that attention shape.
6. The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
SSSP_INF = 1073741823  # the SSSP program's INF
EDGE_FACTOR = 32  # edges per vertex of the paper's RMAT graphs (rmat-19-32)
WARM_RUNS = 5  # warm runs per program; warm_s is their median (host clocks vary)
PAGERANK_RTOL = 1e-4  # float32 engine vs float64 oracle after 20 iterations
PAGERANK_ATOL = 1e-10
FA_TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}  # tests/test_kernels.py's tolerances
# bf16 attention at the path's shapes, beside FA_TOL: max over rows of
# max |kernel - plain| / rms(plain row), the plain version in float32 on the
# same bf16 inputs. It sits between the sound kernel's reading and those of
# the controls (P rounded to fp8, a key tile dropped or doubled), which every
# run computes and requires to fail it (PERF.md has the readings).
ROW_REL_TOL = 5e-2
CONTROL_KEYS = (1024, 1088)  # the key tile a control drops or doubles
KIMI, KIMI_LAYERS = "kimi-k2-1t-a32b", 2  # full width, depth cut to 1 dense + 1 MoE layer
QWEN = "qwen3-0.6b"  # the serving CLI's default arch, full config
LM_BATCH, LM_PROMPT, LM_GEN = 4, 16, 16  # the serving CLI's defaults
PREFILL_LEN = 2048  # qwen3-0.6b bf16 forward: batch LM_BATCH x PREFILL_LEN prompt tokens
PREFILL_RUNS = 3  # timed forwards after one warm-up; the median is kept
SKEW_HUB = 2**20  # edges of the one long bin in edge_stream's skewed case
DECODE_RTOL = 2e-3  # decode vs forward, tests/test_models.py's own tolerance


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` launches (CUDA events,
    after a warm-up)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


PROFILE_TRIES = 3  # profiled windows a measurement may take before it fails


def profiled(run, seen_all=bool, tries: int = PROFILE_TRIES):
    """``run()`` (which launches kernels) under ``torch.profiler``, ended by
    a synchronise: returns the profile, its CUDA kernel events and the
    window's host time. The profiler now and then reports no device event
    for a window that launched kernels; a window whose events fail
    ``seen_all`` (by default: none at all) is run again, up to ``tries``
    times in all, and then the run fails."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if seen_all(kernels):
            return prof, kernels, wall_s
    raise AssertionError(f"the profiler missed kernels in {tries} windows "
                         f"({len(kernels)} events in the last)")


def device_ms(fn, iters: int = 20, warmup: int = 3) -> dict:
    """Mean device time of one ``fn()`` over ``iters`` calls: the summed
    durations of the kernels it launched, from ``torch.profiler`` kernel
    events, so the host's time between launches is left out."""
    for _ in range(warmup):
        fn()

    def calls():
        for _ in range(iters):
            fn()

    _, kernels, _ = profiled(calls, seen_all=lambda k: len(k) >= iters)
    names = sorted({e.name[:80] for e in kernels})
    return {"ms": sum(e.time_range.elapsed_us() for e in kernels) / iters / 1e3,
            "kernels_per_call": len(kernels) / iters, "kernels": names}


def profile_run(run, top: int = 6, focus: str = None) -> dict:
    """One more warm ``run()`` under ``torch.profiler``: its wall time, the
    time the device was busy (kernel intervals merged), and the kernels
    that took the most device time. The profiler slows the host, so the
    idle share it gives is an upper bound of the unprofiled run's."""
    prof, kernels, wall_s = profiled(run)
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top_k = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # host side: time inside PyTorch ops (the rest of the wall time is the
    # Python interpreter and the profiler itself)
    ops = [(e.key, e.self_cpu_time_total) for e in prof.key_averages()]
    top_ops = sorted(ops, key=lambda kv: -kv[1])[:top]
    out = {
        "wall_s": wall_s, "device_kernels": len(kernels), "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s,
        "top_kernels_ms": {name[:80]: us / 1e3 for name, us in top_k},
        "host_ops_s": sum(us for _, us in ops) / 1e6,
        "top_host_ops_ms": {name[:80]: us / 1e3 for name, us in top_ops},
    }
    if focus is not None:
        us = sum(t for name, t in by_name.items() if focus in name)
        out.update({"focus": focus, "focus_ms": us / 1e3,
                    "focus_share_of_busy": us / busy_us if busy_us else None})
    return out


def shuffle_reduce_launches(sr, run) -> list:
    """One more warm ``run()`` with the shape of each ``shuffle_reduce``
    launch recorded (the module's function wrapped for this run only) and
    matched, in launch order, with its device time from profiler kernel
    events. Returns one entry per shape (bins, updates, dtype, op): its
    launches and their mean and total device time, largest total first."""
    shapes = []
    inner = sr.shuffle_reduce_sorted

    def recording(vals, offsets, n_out, op):
        if n_out > 0:  # the wrapper launches nothing for no bins
            shapes.append((n_out, vals.shape[0], str(vals.dtype).split(".")[-1], op))
        return inner(vals, offsets, n_out, op)

    def recorded_run():
        shapes.clear()  # a window the profiler saw nothing of runs again
        run()

    def ours(kernels):
        return [e for e in kernels if "shuffle_reduce_kernel" in e.name]

    sr.shuffle_reduce_sorted = recording
    try:
        _, kernels, _ = profiled(recorded_run, seen_all=lambda k: len(ours(k)) == len(shapes))
    finally:
        sr.shuffle_reduce_sorted = inner
    events = sorted(ours(kernels), key=lambda e: e.time_range.start)
    groups: dict = {}
    for shape, e in zip(shapes, events):
        groups.setdefault(shape, []).append(e.time_range.elapsed_us() / 1e3)
    out = [{"bins": k[0], "updates": k[1], "dtype": k[2], "op": k[3], "launches": len(v),
            "device_ms_mean": sum(v) / len(v), "device_ms_total": sum(v)}
           for k, v in groups.items()]
    return sorted(out, key=lambda r: -r["device_ms_total"])


def bound(n_bytes: int, n_ops: int, ops_per_s: float = F32_OPS_PER_S):
    """Least time the card could take: bytes over HBM rate vs operations
    over the peak rate of their type (float32 by default); returns (ms,
    which one bounds)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_kernels(log_text: str) -> list:
    """Each entry function of a ``ptxas -v`` log: its head dim (the
    template argument), registers and spill bytes."""
    rows: list = []
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            dh = re.search(r"ILi(\d+)E", m.group(1))
            rows.append({"dh": int(dh.group(1)) if dh else None})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and rows:
            rows[-1]["spill_store_bytes"] = int(m.group(1))
            rows[-1]["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    return rows


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------


def f32_sum_tolerance(vals: torch.Tensor, ids: torch.Tensor, n_out: int) -> torch.Tensor:
    """Per-bin bound on |kernel - plain| for a float32 sum of n_b terms
    taken in two orders: each order errs by at most (n_b + 5) * 2^-24 *
    sum|v| (sequential or 32-lane strided plus a 5-level tree), so the two
    differ by at most twice that."""
    ids = ids.long()
    cnt = torch.zeros(n_out, dtype=torch.float64, device=vals.device)
    cnt.index_add_(0, ids, torch.ones_like(vals, dtype=torch.float64))
    abs_sum = torch.zeros(n_out, dtype=torch.float64, device=vals.device)
    abs_sum.index_add_(0, ids, vals.abs().double())
    return 2.0 * (cnt + 5.0) * 2.0**-24 * abs_sum


def check_equal(name: str, got: torch.Tensor, want: torch.Tensor, op: str,
                tol: torch.Tensor = None) -> float:
    """Exact for min/max and int32; float32 + within ``tol`` per bin."""
    assert got.shape == want.shape and got.dtype == want.dtype, (name, got.shape, want.shape)
    if got.dtype == torch.float32:
        finite = torch.isfinite(want)
        assert torch.equal(torch.isfinite(got), finite), f"{name}: non-finite bins differ"
        assert torch.equal(got[~finite], want[~finite]), f"{name}: infinite bins differ"
        err = (got.double() - want.double()).abs()
        err = torch.where(finite, err, torch.zeros_like(err))
        if op == "+":
            assert tol is not None
            bad = int((err > tol).sum())
            assert bad == 0, f"{name}: {bad} bins outside the float-sum bound"
        else:
            assert float(err.max()) == 0.0, f"{name}: not exact"
        return float(err.max()) if err.numel() else 0.0
    assert torch.equal(got, want), f"{name}: not exact"
    return 0.0


def kernel_tests(sr, es, ref, dev: str) -> dict:
    """The reference test shapes (tests/test_kernels.py), kernel vs plain."""
    rng = np.random.default_rng(0)
    n_cases = 0
    max_err = {"shuffle_reduce": 0.0, "edge_stream": 0.0}
    for n, v in [(64, 16), (1000, 300), (4096, 512), (513, 1024), (7, 5)]:
        for op in ("+", "min", "max"):
            for dtype in (np.float32, np.int32):
                # indices up to v + 10: the out-of-range ones are dropped
                idx = torch.from_numpy(rng.integers(0, v + 10, n).astype(np.int32)).to(dev)
                vals = torch.from_numpy(rng.integers(-50, 50, n).astype(dtype)).to(dev)
                got = sr.shuffle_reduce(vals, idx, v, op)
                want = ref.shuffle_reduce_ref(vals, idx, v, op)
                tol = torch.zeros(v, dtype=torch.float64, device=dev)  # integer-valued: exact
                err = check_equal(f"shuffle_reduce n={n} v={v} {op} {dtype.__name__}",
                                  got, want, op, tol)
                max_err["shuffle_reduce"] = max(max_err["shuffle_reduce"], err)
                n_cases += 1
    # empty bins hold the identity
    out = sr.shuffle_reduce(torch.tensor([1.0, 2.0, 3.0], device=dev),
                            torch.tensor([2, 2, 2], dtype=torch.int32, device=dev), 5, "min")
    assert out[2].item() == 1.0 and torch.isinf(out[0]) and torch.isinf(out[4])
    n_cases += 1
    for e, v in [(128, 32), (3000, 400), (5000, 123)]:
        for apply_op in ("add", "mul", "src"):
            for op in ("+", "min", "max"):
                sv = torch.from_numpy(rng.normal(size=e).astype(np.float32)).to(dev)
                w = torch.from_numpy(rng.normal(size=e).astype(np.float32)).to(dev)
                dst = torch.from_numpy(rng.integers(0, v, e).astype(np.int32)).to(dev)
                act = torch.from_numpy(rng.random(e) < 0.4).to(dev)
                got = es.edge_stream(sv, w, dst, act, v, apply_op, op)
                want = ref.edge_stream_ref(sv, w, dst, act, v, apply_op, op)
                upd = ref._apply(apply_op, sv, w)
                tol = f32_sum_tolerance(torch.where(act, upd, 0.0), dst, v)
                err = check_equal(f"edge_stream e={e} v={v} {apply_op} {op}", got, want, op, tol)
                max_err["edge_stream"] = max(max_err["edge_stream"], err)
                n_cases += 1
    return {"cases": n_cases, "max_abs_err": max_err}


def split_facts(sr, split, offsets: torch.Tensor, n_e: int) -> dict:
    """What the bind's work list for edge_stream holds, and what building
    it costs: the median host time (ending in a synchronise) of three more
    builds from the same offsets, which must give the same list. The
    kernel's work items are the chunks, then the bins in quads of four
    (csrc/edge_stream.cu)."""
    build_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = sr.split_bins(offsets, n_e)
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t0)
        assert all(torch.equal(a, b) for a, b in zip(again, split)), "work list differs"
    n_chunks, n_out = split.chunks.shape[0], offsets.shape[0] - 1
    n_b = offsets.clamp(0, n_e).diff().clamp(min=0)
    quad_max = torch.cat([n_b, n_b.new_zeros(-n_out % 4)]).view(-1, 4).amax(dim=1)
    return {"split_len": sr.SPLIT_LEN, "longest_bin": int(n_b.max()),
            "split_bins": split.bins.shape[0], "chunks": n_chunks,
            "work_items": n_chunks + quad_max.shape[0],
            "short_quads": int((quad_max <= 32).sum()),  # walked 8 lanes a bin
            "build_ms": statistics.median(build_s) * 1e3}


def skewed_edge_stream(sr, es, ref, dev: str) -> dict:
    """edge_stream on a stream built to cross the work list's edges: one bin
    of SKEW_HUB edges, bins of L-1, L, L+1, 2L and 2L+1 edges (L =
    SPLIT_LEN), empty bins and a uniform rest of 0-16 edges a bin, in int32
    and float32 under every apply and op, kernel vs plain: exact for int32,
    min and max; float32 + within f32_sum_tolerance and the same bits on
    two calls."""
    big = sr.SPLIT_LEN
    rng = np.random.default_rng(2)
    n_v = 4096
    counts = np.concatenate([[0, SKEW_HUB, 0, big - 1, big, big + 1, 0, 2 * big, 2 * big + 1, 0],
                             rng.integers(0, 17, 60_000)])
    n_out, n_e = counts.shape[0], int(counts.sum())
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)).to(dev)
    src_s = torch.from_numpy(rng.integers(0, n_v, n_e).astype(np.int32)).to(dev)
    eid_s = torch.from_numpy(rng.permutation(n_e).astype(np.int32)).to(dev)
    vact = torch.from_numpy(rng.random(n_v) < 0.6).to(dev)
    split = sr.split_bins(offsets, n_e)
    ids = ref.bin_ids(offsets)
    n_cases, max_err = 0, 0.0
    for dtype in (torch.int32, torch.float32):
        if dtype == torch.int32:  # small enough that no sum wraps
            vval, w = (torch.from_numpy(rng.integers(-30, 30, n).astype(np.int32)).to(dev)
                       for n in (n_v, n_e))
        else:
            vval, w = (torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
                       for n in (n_v, n_e))
        for apply_op in ("add", "mul", "src"):
            eid, ww = (None, None) if apply_op == "src" else (eid_s, w)
            for op in ("+", "min", "max"):
                name = f"edge_stream skewed {str(dtype).split('.')[-1]} {apply_op} {op}"
                got = es.edge_stream_gather(vval, vact, src_s, eid, ww, offsets, apply_op, op,
                                            split)
                want = ref.edge_stream_gather_ref(vval, vact, src_s, eid, ww, offsets, apply_op,
                                                  op)
                tol = None
                if dtype == torch.float32 and op == "+":
                    again = es.edge_stream_gather(vval, vact, src_s, eid, ww, offsets, apply_op,
                                                  op, split)
                    assert torch.equal(got.view(torch.int32), again.view(torch.int32)), \
                        f"{name}: float + differs between two calls"
                    upd = ref._apply(apply_op, vval[src_s], None if ww is None else ww[eid])
                    tol = f32_sum_tolerance(torch.where(vact[src_s], upd, 0.0), ids, n_out)
                max_err = max(max_err, check_equal(name, got, want, op, tol))
                n_cases += 1
    return {"cases": n_cases, "max_abs_err": max_err, "edges": n_e, "bins": n_out,
            "longest_bin": int(counts.max()), "split_bins": split.bins.shape[0],
            "chunks": split.chunks.shape[0], "split_len": sr.SPLIT_LEN}


def main_shape_kernels(sr, es, ref, gb, weights, dev: str) -> dict:
    """Each kernel at the main path's shape: the bound graph's dst-sorted
    edge stream (|E| updates into |V| bins)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    offsets = gb["dst_offsets"]
    n_out = offsets.shape[0] - 1
    n_e = gb["es_src"].shape[0]
    ids = ref.bin_ids(offsets)
    rows = {}

    # -- shuffle_reduce: float32 + (the PageRank-style commit) --------------
    vals = torch.randn(n_e, generator=gen, device=dev)
    got = sr.shuffle_reduce_sorted(vals, offsets, n_out, "+")
    again = sr.shuffle_reduce_sorted(vals, offsets, n_out, "+")
    assert torch.equal(got.view(torch.int32), again.view(torch.int32)), \
        "shuffle_reduce: float + differs between two runs"
    want = ref.segment_reduce_ref(vals, offsets, "+")
    err = check_equal("shuffle_reduce main-shape f32 +", got, want, "+",
                      f32_sum_tolerance(vals, ids, n_out))
    ivals = torch.randint(-2**20, 2**20, (n_e,), generator=gen, device=dev, dtype=torch.int32)
    for op in ("+", "min", "max"):
        check_equal(f"shuffle_reduce main-shape i32 {op}",
                    sr.shuffle_reduce_sorted(ivals, offsets, n_out, op),
                    ref.segment_reduce_ref(ivals, offsets, op), op)
    # the library calls that compute the same sum (the port calls neither)
    lib_out = torch.zeros(n_out, device=dev)
    ids_l = ids.long()
    b_ms, b_by = bound(4 * n_e + 4 * (n_out + 1) + 4 * n_out, n_e)
    rows["shuffle_reduce"] = {
        "kernel_ms": time_ms(lambda: sr.shuffle_reduce_sorted(vals, offsets, n_out, "+")),
        "plain_ms": time_ms(lambda: ref.segment_reduce_ref(vals, offsets, "+"), iters=5),
        "library_ms": time_ms(lambda: lib_out.scatter_reduce_(0, ids_l, vals, "sum")),
        "library_call": "torch.Tensor.scatter_reduce_",
        "index_add_ms": time_ms(lambda: lib_out.index_add_(0, ids, vals)),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
        "shape": {"updates": n_e, "bins": n_out, "dtype": "float32", "op": "+"},
    }

    # -- edge_stream: the SSSP relax (int32, add weight, min) and the
    #    PageRank contribution (float32, src, +) on the bound graph -------
    n_v = gb["n_vertices"]
    split = gb["es_split"]  # the work list the bind built, as the engine's launches use it
    vact = torch.rand(n_v, generator=gen, device=dev) < 0.5
    sp = torch.randint(0, 2**20, (n_v,), generator=gen, device=dev, dtype=torch.int32)
    w = weights
    got = es.edge_stream_gather(sp, vact, gb["es_src"], gb["es_eid"], w, offsets, "add", "min",
                                split)
    want = ref.edge_stream_gather_ref(sp, vact, gb["es_src"], gb["es_eid"], w, offsets,
                                      "add", "min")
    err_i = check_equal("edge_stream main-shape i32 add min", got, want, "min")
    n_active = int(vact[gb["es_src"]].sum())
    b_ms, b_by = bound(4 * n_e + 8 * n_active + 5 * n_v + 8 * n_out + 4, 2 * n_active)
    dev_i = device_ms(lambda: es.edge_stream_gather(
        sp, vact, gb["es_src"], gb["es_eid"], w, offsets, "add", "min", split))
    # the same stream with apply 'src': what the weight gather by edge id costs
    dev_s = device_ms(lambda: es.edge_stream_gather(
        sp, vact, gb["es_src"], None, None, offsets, "src", "min", split))
    rows["edge_stream"] = {
        "kernel_ms": time_ms(lambda: es.edge_stream_gather(
            sp, vact, gb["es_src"], gb["es_eid"], w, offsets, "add", "min", split)),
        "kernel_device_ms": dev_i["ms"], "kernel_device_kernels": dev_i["kernels"],
        "src_apply_device_ms": dev_s["ms"],
        "plain_ms": time_ms(lambda: ref.edge_stream_gather_ref(
            sp, vact, gb["es_src"], gb["es_eid"], w, offsets, "add", "min"), iters=5),
        "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err_i,
        "shape": {"edges": n_e, "bins": n_out, "dtype": "int32", "apply": "add",
                  "op": "min", "active_edges": n_active},
        "work_list": split_facts(sr, split, offsets, n_e),
    }
    rank = torch.rand(n_v, generator=gen, device=dev)
    got = es.edge_stream_gather(rank, vact, gb["es_src"], None, None, offsets, "src", "+",
                                split)
    again = es.edge_stream_gather(rank, vact, gb["es_src"], None, None, offsets, "src", "+",
                                  split)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32)), \
        "edge_stream: float + differs between two runs"
    want = ref.edge_stream_gather_ref(rank, vact, gb["es_src"], None, None, offsets, "src", "+")
    upd = torch.where(vact, rank, 0.0)[gb["es_src"]]
    err_f = check_equal("edge_stream main-shape f32 src +", got, want, "+",
                        f32_sum_tolerance(upd, ids, n_out))
    b_ms, b_by = bound(4 * n_e + 5 * n_v + 8 * n_out + 4, n_e)
    dev_f = device_ms(lambda: es.edge_stream_gather(
        rank, vact, gb["es_src"], None, None, offsets, "src", "+", split))
    rows["edge_stream_f32"] = {
        "kernel_ms": time_ms(lambda: es.edge_stream_gather(
            rank, vact, gb["es_src"], None, None, offsets, "src", "+", split)),
        "kernel_device_ms": dev_f["ms"], "kernel_device_kernels": dev_f["kernels"],
        "plain_ms": time_ms(lambda: ref.edge_stream_gather_ref(
            rank, vact, gb["es_src"], None, None, offsets, "src", "+"), iters=5),
        "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err_f,
        "shape": {"edges": n_e, "bins": n_out, "dtype": "float32", "apply": "src", "op": "+"},
    }
    return rows


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Attention kernel vs plain version within the reference tests'
    tolerance of the dtype; returns the max abs error."""
    assert got.shape == want.shape and got.dtype == want.dtype, (name, got.shape, want.shape)
    assert torch.isfinite(got).all(), f"{name}: non-finite output"
    err = float((got.float() - want.float()).abs().max())
    tol = FA_TOL[got.dtype]
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    assert ok, f"{name}: max abs error {err} outside {tol}"
    return err


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max over rows of max |got - want| / rms(want row): an error that
    scales with each row's output, so a fault confined to long rows (whose
    outputs are small) is not hidden by an absolute tolerance."""
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(dim=-1).sqrt().clamp_min(1e-30)
    return float(((g - w).abs().amax(dim=-1) / rms).max())


def attention_control(q, k, v, causal: bool, p_dtype=torch.bfloat16,
                      tile_weight: float = 1.0) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in plain PyTorch, with a fault
    to show what the row-relative check catches: float32 scores, max and
    sum, P rounded to ``p_dtype`` before P.V (the kernel rounds it to bf16),
    and the keys of CONTROL_KEYS counted ``tile_weight`` times (0: a key
    tile skipped, 2: one taken twice); output in q's dtype."""
    b, h, lq, dh = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    k, v = (t.float().repeat_interleave(h // hkv, dim=1) for t in (k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) / math.sqrt(dh)
    k_pos = torch.arange(lk, device=q.device)
    if causal:
        q_pos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        logits.masked_fill_(k_pos[None, :] > q_pos, float("-inf"))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    del logits
    lo, hi = CONTROL_KEYS
    p[..., lo:hi] *= tile_weight
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(p_dtype).float(), v) / denom
    return out.to(q.dtype)


def check_row_rel(name: str, got: torch.Tensor, q, k, v, causal: bool, ref) -> dict:
    """The bf16 kernel's output against the plain version in float32 on
    the same inputs, by :func:`row_rel_err`, within ROW_REL_TOL; and three
    controls, each of which must fall outside it, so that the check is
    shown able to fail at this shape in this run."""
    assert q.shape[2] > CONTROL_KEYS[1] and k.shape[2] > CONTROL_KEYS[1], name
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal)
    err = row_rel_err(got, want)
    controls = {
        "p_fp8_e4m3": row_rel_err(attention_control(q, k, v, causal, torch.float8_e4m3fn), want),
        "key_tile_dropped": row_rel_err(attention_control(q, k, v, causal, tile_weight=0.0),
                                        want),
        "key_tile_doubled": row_rel_err(attention_control(q, k, v, causal, tile_weight=2.0),
                                        want),
    }
    del want
    caught = {c: r > ROW_REL_TOL for c, r in controls.items()}
    assert all(caught.values()), f"{name}: a control passes the row-relative check: {controls}"
    assert err <= ROW_REL_TOL, f"{name}: row-relative error {err} outside {ROW_REL_TOL}"
    return {"row_rel_err": err, "row_rel_tol": ROW_REL_TOL, "controls": controls,
            "control_keys": list(CONTROL_KEYS)}


def lm_kernel_tests(fa, md, ref, dev: str) -> dict:
    """The LM kernels at the reference test shapes (tests/test_kernels.py),
    kernel vs plain: attention in float32 (the CUDA-core kernel) and bf16
    (the tensor-core kernel), the gather exactly. Each attention case reads
    the route its launch took from the two launch counters."""
    rng = np.random.default_rng(1)
    n_cases = 0
    max_err = {"flash_attention_float32": 0.0, "flash_attention_bfloat16": 0.0,
               "moe_gather": 0.0}
    routes = {"cuda_core": 0, "sm90": 0}
    for b, h, hkv, lq, lk, dh in [(1, 2, 2, 64, 64, 32), (2, 4, 2, 128, 128, 64),
                                  (1, 4, 1, 1, 256, 64), (1, 2, 2, 100, 100, 32)]:
        for causal, window in [(True, 0), (False, 0), (True, 48)]:
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                           .to(dev, dtype) for shape in
                           [(b, h, lq, dh), (b, hkv, lk, dh), (b, hkv, lk, dh)])
                name = (f"flash_attention {b, h, hkv, lq, lk, dh} causal={causal} "
                        f"window={window} {dtype}")
                before = (fa.LAUNCHES, fa.SM90_LAUNCHES)
                got = fa.flash_attention(q, k, v, causal, window)
                took = "sm90" if fa.SM90_LAUNCHES > before[1] else "cuda_core"
                assert fa.LAUNCHES == before[0] + 1, f"{name}: no launch"
                assert took == fa._route(q) == ("sm90" if dtype == torch.bfloat16
                                                else "cuda_core"), f"{name}: took {took}"
                routes[took] += 1
                err = check_close(name, got, ref.flash_attention_ref(q, k, v, causal, window))
                key = f"flash_attention_{str(dtype).split('.')[-1]}"
                max_err[key] = max(max_err[key], err)
                n_cases += 1
    for e, c, d, bc in [(8, 256, 64, 128), (4, 128, 32, 128), (16, 512, 128, 128)]:
        sizes = np.minimum(rng.multinomial(e * c // 2, np.ones(e) / e), c).astype(np.int32)
        aligned = ((sizes + bc - 1) // bc) * bc
        offs = np.zeros(e, np.int32)
        offs[1:] = np.cumsum(aligned)[:-1]
        tok = torch.from_numpy(rng.normal(size=(int(offs[-1] + aligned[-1]), d))
                               .astype(np.float32)).to(dev)
        offs_t, sizes_t = torch.from_numpy(offs).to(dev), torch.from_numpy(sizes).to(dev)
        got = md.moe_gather(tok, offs_t, sizes_t, c)
        want = ref.moe_gather_ref(tok[None], None, offs_t[None], sizes_t[None], c)[0]
        assert torch.equal(got, want), f"moe_gather e={e} c={c} d={d}: not exact"
        n_cases += 1
    return {"cases": n_cases, "max_abs_err": max_err, "attention_routes": routes}


def _attention_row(fa, ref, q, k, v, causal: bool, pairs: int, plain_iters: int,
                   device_side: bool = False) -> dict:
    """Kernel vs plain at one shape, timed beside the library call that
    computes the same function (SDPA with GQA; at Lq = 1 over the whole
    cache every key is visible, so it is called without a causal mask,
    whose alignment differs). ``pairs`` is the unmasked (query, key)
    pairs of each head: 4 * Dh FLOPs each (two products), bounded at the
    peak rate of the dtype (bf16 tensor cores, float32 CUDA cores).
    ``device_side`` adds the device time of kernel and library call from
    profiler events (the host-paced loop times the wrapper's Python at
    decode size)."""
    b, h, lq, dh = q.shape
    route = fa._route(q)
    before = fa.SM90_LAUNCHES
    got = fa.flash_attention(q, k, v, causal)
    assert (fa.SM90_LAUNCHES > before) == (route == "sm90"), route
    err = check_close(f"flash_attention {tuple(q.shape)} over {tuple(k.shape)} {q.dtype}",
                      got, ref.flash_attention_ref(q, k, v, causal))
    rel = None
    if q.dtype == torch.bfloat16 and lq > CONTROL_KEYS[1]:
        rel = check_row_rel(f"flash_attention_sm90 {tuple(q.shape)}", got, q, k, v, causal, ref)
    lib_causal = causal and lq > 1
    lib = F.scaled_dot_product_attention(q, k, v, is_causal=lib_causal, enable_gqa=True)
    lib_diff = float((lib.float() - got.float()).abs().max())
    if q.dtype == torch.bfloat16:
        check_close("scaled_dot_product_attention", lib, got)
    n_bytes = 2 * q.numel() * q.element_size() + (k.numel() + v.numel()) * k.element_size()
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else F32_OPS_PER_S
    b_ms, b_by = bound(n_bytes, 4 * b * h * pairs * dh, rate)
    row = {
        "route": route,
        "kernel_ms": time_ms(lambda: fa.flash_attention(q, k, v, causal)),
        "plain_ms": time_ms(lambda: ref.flash_attention_ref(q, k, v, causal),
                            iters=plain_iters, warmup=1),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=lib_causal, enable_gqa=True)),
        "library_call": "torch.nn.functional.scaled_dot_product_attention(enable_gqa=True)",
        "library_max_abs_diff": lib_diff,
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
        "shape": {"q": list(q.shape), "kv": list(k.shape), "q_strides": list(q.stride()),
                  "kv_strides": list(k.stride()), "dtype": str(q.dtype), "causal": causal},
    }
    if rel is not None:
        row["row_rel_check"] = rel
    row["bound_share"] = b_ms / row["kernel_ms"]
    row["kernel_over_library"] = row["kernel_ms"] / row["library_ms"]
    if device_side:
        kd = device_ms(lambda: fa.flash_attention(q, k, v, causal))
        ld = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=lib_causal, enable_gqa=True))
        row.update({"kernel_device_ms": kd["ms"], "kernel_device_kernels": kd["kernels"],
                    "library_device_ms": ld["ms"], "library_device_kernels": ld["kernels"]})
    return row


def _dispatch_row(md, ref, moe_mod, cfg, n_tokens: int, gen, plain_iters: int,
                  device_side: bool = False) -> dict:
    """The MoE layer's dispatch of ``n_tokens`` tokens (its own groups,
    capacity and routing plan for random top-k experts), kernel vs plain
    (exact), beside ``index_select`` over a zero-padded token table with a
    precomputed slot -> row map (the library call for the same gather).
    ``device_side`` adds both calls' device times from profiler events."""
    dev = gen.device
    e, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    g = moe_mod._dispatch_groups(n_tokens)
    tg = n_tokens // g
    cap = int(max(1, math.ceil(cfg.moe_capacity_factor * tg * k / e)))
    x = torch.randn(g, tg, d, generator=gen, device=dev).bfloat16()
    top_e = torch.rand(g, tg, e, generator=gen, device=dev).topk(k, dim=-1).indices
    _, order, offsets, sizes = moe_mod.route(top_e, e, cap)
    rows = (order // k).to(torch.int32)
    offsets, sizes = offsets.to(torch.int32), sizes.to(torch.int32)
    got = md.moe_gather(x, offsets, sizes, cap, rows)
    assert torch.equal(got, ref.moe_gather_ref(x, rows, offsets, sizes, cap)), \
        f"moe_gather {n_tokens} tokens: not exact"
    # the library form: one index_select over [x; 0] with a slot -> row map
    c = torch.arange(cap, device=dev)
    slot = (offsets.long()[..., None] + c).clamp(max=tg * k - 1)
    row = rows.long().gather(1, slot.reshape(g, -1)).reshape(slot.shape)
    live = c < sizes.long()[..., None]
    flat = torch.where(live, row + tg * torch.arange(g, device=dev)[:, None, None], g * tg)
    flat = flat.reshape(-1)
    table = torch.cat([x.reshape(g * tg, d), torch.zeros(1, d, dtype=x.dtype, device=dev)])
    assert torch.equal(torch.index_select(table, 0, flat).reshape(got.shape), got)
    live_rows = int(sizes.sum())
    read_rows = int(torch.unique(flat[flat < g * tg]).numel())  # token rows the run needs
    n_bytes = got.numel() * 2 + read_rows * d * 2 + 4 * (2 * g * e + live_rows)
    b_ms, b_by = bound(n_bytes, 0)
    row = {
        "kernel_ms": time_ms(lambda: md.moe_gather(x, offsets, sizes, cap, rows)),
        "plain_ms": time_ms(lambda: ref.moe_gather_ref(x, rows, offsets, sizes, cap),
                            iters=plain_iters, warmup=1),
        "library_ms": time_ms(lambda: torch.index_select(table, 0, flat)),
        "library_call": "torch.index_select (slot -> row map precomputed)",
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0,
        "shape": {"tokens": n_tokens, "groups": g, "experts": e, "capacity": cap, "d": d,
                  "out": list(got.shape), "live_rows": live_rows, "token_rows_read": read_rows,
                  "dtype": "bfloat16"},
    }
    if device_side:
        kd = device_ms(lambda: md.moe_gather(x, offsets, sizes, cap, rows))
        ld = device_ms(lambda: torch.index_select(table, 0, flat))
        row.update({"kernel_device_ms": kd["ms"], "kernel_device_kernels": kd["kernels"],
                    "library_device_ms": ld["ms"], "library_device_kernels": ld["kernels"]})
    return row


def lm_main_shape_kernels(fa, md, ref, moe_mod, cfg, dev: str) -> dict:
    """Each LM kernel at the Kimi-K2 path's shapes: the last decode step's
    attention (one query per head over the 32-slot cache, read in its
    [B, buf, Hkv, Dh] layout) and a prefill-size causal attention, each in
    bf16 (the tensor-core kernel) and in float32 (the CUDA-core kernel);
    the decode step's dispatch and a 4096-token prefill dispatch."""
    gen = torch.Generator(device=dev).manual_seed(1)
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    buf = LM_PROMPT + LM_GEN
    rows = {}
    for dtype, name in ((torch.bfloat16, "flash_attention_sm90"),
                        (torch.float32, "flash_attention")):
        q = torch.randn(LM_BATCH, 1, h, dh, generator=gen, device=dev).to(dtype)
        ck, cv = (torch.randn(LM_BATCH, buf, hkv, dh, generator=gen, device=dev).to(dtype)
                  for _ in range(2))
        rows[f"{name}_decode"] = _attention_row(
            fa, ref, q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2), True, buf, 20,
            device_side=True)
        s = 2048
        q, k, v = (torch.randn(1, n, s, dh, generator=gen, device=dev).to(dtype)
                   for n in (h, hkv, hkv))
        rows[name] = _attention_row(fa, ref, q, k, v, True, s * (s + 1) // 2, 3)
        del q, k, v, ck, cv
    rows["moe_gather"] = _dispatch_row(md, ref, moe_mod, cfg, LM_BATCH, gen, 20,
                                       device_side=True)
    rows["moe_gather_prefill"] = _dispatch_row(md, ref, moe_mod, cfg, 4096, gen, 3,
                                               device_side=True)
    return rows


def lm_phase(repro_torch_mods, dev: str, seed: int) -> dict:
    """Kimi-K2 at full width, depth cut to 2 layers, bf16: ``generate``
    twice (batch 4, prompt 16, generate 16) plus one ``forward`` over the
    prompts and one ``decode_step``, with the LM kernels' counters set to 0
    just before and read just after."""
    fa, md, get_config, Model, serve = repro_torch_mods
    cfg = get_config(KIMI).scaled(n_layers=KIMI_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, dtype=torch.bfloat16, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to(dev)

    fa.LAUNCHES = 0
    fa.SM90_LAUNCHES = 0
    md.LAUNCHES = 0
    step_s: list = []
    t0 = time.perf_counter()
    first = serve.generate(model, prompts, LM_GEN, step_s=step_s).cpu()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    second = serve.generate(model, prompts, LM_GEN).cpu()
    second_s = time.perf_counter() - t0
    logits, aux = model.forward(prompts)
    step_logits, _ = model.decode_step(model.init_cache(LM_BATCH, 1), prompts[:, :1])
    decode_aux = dict(model.last_aux)
    torch.cuda.synchronize()
    launches = {"flash_attention_sm90": fa.SM90_LAUNCHES,
                "flash_attention": fa.LAUNCHES - fa.SM90_LAUNCHES, "moe_gather": md.LAUNCHES}

    assert torch.equal(first, second), "Kimi-K2: two generate runs gave different tokens"
    assert first.shape == (LM_BATCH, LM_GEN)
    assert bool(((first >= 0) & (first < cfg.vocab_size)).all())
    assert logits.shape == (LM_BATCH, LM_PROMPT, cfg.vocab_size)
    assert torch.isfinite(logits).all() and torch.isfinite(step_logits).all(), \
        "Kimi-K2: non-finite logits"
    assert launches["flash_attention_sm90"] > 0, \
        "the tensor-core flash kernel never launched on the bf16 LM path"
    assert launches["flash_attention"] == 0, "a bf16 attention took the CUDA-core kernel"
    assert launches["moe_gather"] > 0, "moe_gather never launched on the LM path"
    embed_bytes = model.embed.numel() * model.embed.element_size()
    # bytes one decode step must read: every weight but the embedding table
    # (of which it gathers LM_BATCH rows); the dense MoE einsum reads every expert
    step_bytes = model.param_bytes() - embed_bytes + LM_BATCH * cfg.d_model * 2
    median_ms = statistics.median(step_s) * 1e3
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    row = {
        "phase": "lm", "model": KIMI, "dtype": "bfloat16",
        "config": {key: getattr(cfg, key) for key in (
            "d_model", "n_layers", "first_dense_layers", "n_heads", "n_kv_heads", "head_dim",
            "d_ff", "n_experts", "n_shared_experts", "top_k", "moe_d_ff", "vocab_size")},
        "reduced": {"n_layers": [get_config(KIMI).n_layers, KIMI_LAYERS]},
        "batch": LM_BATCH, "prompt_len": LM_PROMPT, "gen_len": LM_GEN,
        "param_bytes": model.param_bytes(), "init_s": init_s,
        "decode_steps": len(step_s), "median_step_ms": median_ms,
        "step_ms_min_max": [min(step_s) * 1e3, max(step_s) * 1e3],
        "first_run_s": first_s, "second_run_s": second_s,
        "tokens_per_s": LM_BATCH * (LM_PROMPT + LM_GEN) / second_s,
        "step_weight_bytes": step_bytes, "step_bound_ms": bound_ms,
        "step_bound_share": bound_ms / median_ms,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "forward_drop_fraction": float(aux["drop_fraction"]),
        "forward_load_balance_loss": float(aux["load_balance_loss"]),
        "decode_drop_fraction": float(decode_aux["drop_fraction"]),
        "tokens_identical": True, "tokens": first[:2].tolist(), "launches": launches,
        "profile_decode_step": _profile_step(model, prompts),
    }
    del model, logits, step_logits
    return row


def _profile_step(model, prompts) -> dict:
    """One warm decode step (at the last position of a full cache) under
    the profiler: where a step's time goes, on the device and the host."""
    cache = model.init_cache(prompts.shape[0], LM_PROMPT)
    for t in range(LM_PROMPT - 1):
        _, cache = model.decode_step(cache, prompts[:, t:t + 1])
    return profile_run(lambda: model.decode_step(cache, prompts[:, -1:]), top=8)


def qwen_phase(repro_torch_mods, dev: str, seed: int) -> dict:
    """qwen3-0.6b at its full config in float32: ``generate`` timed as on
    Kimi-K2, then decode logits at every position against the
    whole-sequence forward (the kernel at Lq = 1 and at Lq = S), within
    ``2e-3 * max(1, |logits|)``."""
    fa, md, get_config, Model, serve = repro_torch_mods
    cfg = get_config(QWEN)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, dtype=torch.float32, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT))).to(dev)
    fa.LAUNCHES = 0
    fa.SM90_LAUNCHES = 0
    step_s: list = []
    serve.generate(model, prompts, LM_GEN, step_s=step_s)
    t0 = time.perf_counter()
    serve.generate(model, prompts, LM_GEN).cpu()
    run_s = time.perf_counter() - t0
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, LM_PROMPT))).to(dev)
    full, _ = model.forward(toks)
    cache = model.init_cache(2, LM_PROMPT)
    worst = 0.0
    for t in range(LM_PROMPT):
        step, cache = model.decode_step(cache, toks[:, t:t + 1])
        err = float((step[:, 0] - full[:, t]).abs().max())
        scale = max(1.0, float(full[:, t].abs().max()))
        assert err < DECODE_RTOL * scale, f"{QWEN} t={t}: decode vs forward {err} (scale {scale})"
        worst = max(worst, err / scale)
    assert torch.isfinite(full).all()
    launches = {"flash_attention": fa.LAUNCHES - fa.SM90_LAUNCHES,
                "flash_attention_sm90": fa.SM90_LAUNCHES}
    assert launches["flash_attention"] > 0, "the CUDA-core flash kernel never launched (f32)"
    assert launches["flash_attention_sm90"] == 0, "a float32 attention took the sm90 kernel"
    median_ms = statistics.median(step_s) * 1e3
    bound_ms = model.param_bytes() / HBM_BYTES_PER_S * 1e3  # tied head: the table is read
    row = {
        "phase": "lm", "model": QWEN, "dtype": "float32", "reduced": {},
        "batch": LM_BATCH, "prompt_len": LM_PROMPT, "gen_len": LM_GEN,
        "param_bytes": model.param_bytes(), "decode_steps": len(step_s),
        "median_step_ms": median_ms, "step_ms_min_max": [min(step_s) * 1e3, max(step_s) * 1e3],
        "tokens_per_s": LM_BATCH * (LM_PROMPT + LM_GEN) / run_s,
        "step_bound_ms": bound_ms, "step_bound_share": bound_ms / median_ms,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "decode_vs_forward": {"positions": LM_PROMPT, "max_err_over_scale": worst,
                              "rtol": DECODE_RTOL},
        "launches": launches,
    }
    row["profile_decode_step"] = _profile_step(model, prompts)
    del model, full
    return row


def qwen_prefill_phase(repro_torch_mods, ref, dev: str, seed: int) -> dict:
    """qwen3-0.6b at its full config in bf16 (as ``launch/serve.py`` runs
    it): ``Model.forward`` over LM_BATCH x PREFILL_LEN prompt tokens from
    the seed. First the tensor-core kernel is held to its plain version at
    exactly that forward's attention shape and layout; then one warm-up
    forward with the counters set to 0 just before and read just after
    (one sm90 launch per layer), PREFILL_RUNS timed forwards (host clock
    ending in a synchronise; the median is kept) and one profiled forward
    (device busy time and the flash kernel's share of it)."""
    fa, md, get_config, Model, serve = repro_torch_mods
    cfg = get_config(QWEN)
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    # the forward's layout: [B, L, H, Dh] activations viewed as [B, H, L, Dh]
    q, k, v = (torch.randn(LM_BATCH, PREFILL_LEN, n, dh, generator=gen, device=dev)
               .bfloat16().transpose(1, 2) for n in (h, hkv, hkv))
    before = fa.SM90_LAUNCHES
    got = fa.flash_attention(q, k, v, True)
    assert fa.SM90_LAUNCHES == before + 1
    name = f"flash_attention_sm90 {tuple(q.shape)} over {tuple(k.shape)}"
    shape_err = check_close(name, got, ref.flash_attention_ref(q, k, v, True))
    rel = check_row_rel(name, got, q, k, v, True, ref)
    shape = {"q": list(q.shape), "kv": list(k.shape), "causal": True, "dtype": "bfloat16"}
    del q, k, v, got
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, dtype=torch.bfloat16, device=dev)
    model.init(torch.Generator(device=dev).manual_seed(seed))
    tokens = torch.from_numpy(np.random.default_rng(seed + 2).integers(
        0, cfg.vocab_size, (LM_BATCH, PREFILL_LEN))).to(dev)
    fa.LAUNCHES = 0
    fa.SM90_LAUNCHES = 0
    logits, _ = model.forward(tokens)
    torch.cuda.synchronize()
    launches = {"flash_attention_sm90": fa.SM90_LAUNCHES,
                "flash_attention": fa.LAUNCHES - fa.SM90_LAUNCHES}
    assert launches == {"flash_attention_sm90": cfg.n_layers, "flash_attention": 0}, launches
    assert logits.shape == (LM_BATCH, PREFILL_LEN, cfg.vocab_size)
    assert torch.isfinite(logits).all(), f"{QWEN} bf16 forward: non-finite logits"
    del logits
    runs_s = []
    for _ in range(PREFILL_RUNS):
        t0 = time.perf_counter()
        model.forward(tokens)
        torch.cuda.synchronize()
        runs_s.append(time.perf_counter() - t0)
    prof = profile_run(lambda: model.forward(tokens), top=8, focus="flash_attention_sm90")
    pairs = PREFILL_LEN * (PREFILL_LEN + 1) // 2
    attn_flop = cfg.n_layers * 4 * LM_BATCH * h * pairs * dh
    row = {
        "phase": "lm_prefill", "model": QWEN, "dtype": "bfloat16", "reduced": {},
        "batch": LM_BATCH, "prompt_len": PREFILL_LEN,
        "kernel_check": {"shape": shape, "max_abs_err": shape_err,
                         "tol": FA_TOL[torch.bfloat16], **rel},
        "forward_ms_median": statistics.median(runs_s) * 1e3,
        "forward_ms_runs": [t * 1e3 for t in runs_s],
        "attention_flop": attn_flop,
        "attention_bound_ms": attn_flop / BF16_OPS_PER_S * 1e3,
        "launches_per_forward": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "profile_forward": prof,
    }
    del model
    return row


# ---------------------------------------------------------------------------
# oracles (numpy / scipy, independent of the port)
# ---------------------------------------------------------------------------


def bfs_levels(n: int, src: np.ndarray, dst: np.ndarray, root: int) -> np.ndarray:
    """BFS_ECP's old_level: 1 at the root, BFS depth + 1, -1 unreached."""
    order = np.argsort(src, kind="stable")
    indices = dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    level = np.full(n, -1, dtype=np.int64)
    level[root] = 1
    frontier = np.array([root], dtype=np.int64)
    depth = 1
    while frontier.size:
        starts, counts = indptr[frontier], indptr[frontier + 1] - indptr[frontier]
        total = int(counts.sum())
        base = np.repeat(starts - np.cumsum(counts) + counts, counts)
        nb = indices[base + np.arange(total)]
        nb = np.unique(nb[level[nb] < 0])
        depth += 1
        level[nb] = depth
        frontier = nb
    return level.astype(np.int32)


def sssp_dist(n: int, src, dst, w, root: int) -> np.ndarray:
    """scipy Dijkstra after reducing parallel edges to their minimum weight
    (scipy sums duplicate entries); unreached -> the program's INF."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    key = src.astype(np.int64) * n + dst
    order = np.lexsort((w, key))
    key, w_s = key[order], w[order]
    first = np.ones(key.shape[0], dtype=bool)
    first[1:] = key[1:] != key[:-1]
    key, w_min = key[first], w_s[first]
    mat = csr_matrix((w_min.astype(np.float64), (key // n, key % n)), shape=(n, n))
    d = dijkstra(mat, directed=True, indices=root)
    return np.where(np.isinf(d), SSSP_INF, d).astype(np.int64)


def pagerank(n: int, src, dst, iters: int, damp: float = 0.85) -> np.ndarray:
    """The PAGERANK program's iteration in float64 (dangling mass drops)."""
    deg = np.bincount(src, minlength=n).astype(np.float64)
    rank = np.full(n, 1.0 / n)
    for _ in range(iters):
        contrib = np.bincount(dst, weights=rank[src] / deg[src], minlength=n)
        rank = (1.0 - damp) / n + damp * contrib
    return rank


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=19, help="RMAT scale (19 = R19)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # -- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    import repro_torch
    from repro_torch.algorithms import sources
    from repro_torch.graph import generators
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import edge_stream as es
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_dispatch as md
    from repro_torch.kernels import shuffle_reduce as sr
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.models import moe as moe_mod

    dev = "cuda"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    card = {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    log({"phase": "device", **card})

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build(verbose=True)
    build_s = time.perf_counter() - t0
    for name, info in built.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", info["log"])]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill", info["log"])]
        log({"phase": "build", "source": f"src/repro_torch/csrc/{name}.cu",
             "seconds": round(info["seconds"], 3), "cached": info["cached"],
             "ptxas": {"kernels": len(regs), "max_registers": max(regs, default=None),
                       "spill_bytes": sum(spills)}})
    log({"phase": "build", "total_seconds": round(build_s, 3)})
    sm90_lib = _build.load("flash_attention_sm90")
    sm90 = ptxas_kernels(built["flash_attention_sm90"]["log"])
    for row in sm90:
        row["dynamic_smem_bytes"] = sm90_lib.repro_flash_attention_sm90_smem_bytes(row["dh"])
    log({"phase": "build", "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "kernels": sm90, "ptxas_warnings": [line.strip() for line in
                                             built["flash_attention_sm90"]["log"].splitlines()
                                             if "warning" in line]})

    # -- graph and the SSSP bind (whose bindings give the main-path shape) --
    t0 = time.perf_counter()
    g = generators.rmat(args.scale, EDGE_FACTOR, seed=args.seed, weighted=True)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sessions = {"SSSP": repro_torch.compile(sources.SSSP).bind(g, device=dev)}
    bind_s = {"SSSP": time.perf_counter() - t0}
    log({"phase": "graph", "name": f"rmat-{args.scale}-{EDGE_FACTOR}",
         "vertices": g.n_vertices, "edges": g.n_edges, "generate_s": round(gen_s, 3),
         "bind_s": round(bind_s["SSSP"], 3)})

    # -- 3. kernels vs plain versions ----------------------------------------
    small = kernel_tests(sr, es, ref, dev)
    log({"phase": "kernels", "reference_shapes": small})
    eng = sessions["SSSP"].engine
    rows = main_shape_kernels(sr, es, ref, eng.gb, eng.state["__weight__"], dev)
    for name, row in rows.items():
        log({"phase": "kernels", "kernel": name, **row})
    log({"phase": "kernels", "skewed_edge_stream": skewed_edge_stream(sr, es, ref, dev)})
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    log({"phase": "kernels", "reference_shapes_lm": lm_kernel_tests(fa, md, ref, dev)})
    lm_rows = lm_main_shape_kernels(fa, md, ref, moe_mod, get_config(KIMI), dev)
    for name, row in lm_rows.items():
        log({"phase": "kernels", "kernel": name, **row})
    rows.update(lm_rows)
    torch.cuda.synchronize()

    # -- 4. the main path ---------------------------------------------------
    src_np, dst_np = g.src, g.dst
    oracles = {
        "BFS_ECP": ("old_level", lambda: bfs_levels(g.n_vertices, src_np, dst_np, 0)),
        "PAGERANK": ("rank", lambda: pagerank(g.n_vertices, src_np, dst_np, 20)),
        "SSSP": ("SP", lambda: sssp_dist(g.n_vertices, src_np, dst_np,
                                         g.weights.astype(np.int64), 0)),
    }
    params = {"BFS_ECP": {"root": 0}, "PAGERANK": {"iters": 20}, "SSSP": {"root": 0}}
    for name in ("BFS_ECP", "PAGERANK"):
        t0 = time.perf_counter()
        sessions[name] = repro_torch.compile(getattr(sources, name)).bind(g, device=dev)
        bind_s[name] = time.perf_counter() - t0
    sr.LAUNCHES = 0
    es.LAUNCHES = 0
    results, resident, peak = {}, {}, {}
    for name in ("BFS_ECP", "PAGERANK", "SSSP"):
        sess = sessions[name]
        resident[name] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cold = sess.run(**params[name])
        cold_s = time.perf_counter() - t0
        warm_runs_s = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            warm = sess.run(**params[name])
            warm_runs_s.append(time.perf_counter() - t0)
        peak[name] = torch.cuda.max_memory_allocated()
        results[name] = (cold, warm, cold_s, warm_runs_s)
    launches = {"shuffle_reduce": sr.LAUNCHES, "edge_stream": es.LAUNCHES}
    for name, (cold, warm, cold_s, warm_runs_s) in results.items():
        warm_s = statistics.median(warm_runs_s)
        prop, oracle = oracles[name]
        want = oracle()
        got = warm.properties[prop]
        assert got.shape == want.shape and np.all(np.isfinite(got)), name
        for k in cold.properties:
            assert np.array_equal(cold.properties[k], warm.properties[k]), \
                f"{name}: cold and warm runs differ in {k}"
        if name == "PAGERANK":
            rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
            assert np.allclose(got, want, rtol=PAGERANK_RTOL, atol=PAGERANK_ATOL), \
                f"PAGERANK: max rel err {rel.max():.3e}"
            agree = {"rtol": PAGERANK_RTOL, "atol": PAGERANK_ATOL,
                     "max_rel_err": float(rel.max()),
                     "max_abs_err": float(np.abs(got - want).max())}
        else:
            bad = int((got.astype(np.int64) != want).sum())
            assert bad == 0, f"{name}: {bad} vertices differ from the oracle"
            agree = {"exact": True, "reached": int((want != (-1 if name == "BFS_ECP"
                                                             else SSSP_INF)).sum())}
        st = warm.stats
        log({"phase": "main", "program": name, "params": params[name],
             "bind_s": round(bind_s[name], 3), "cold_s": cold_s, "warm_s": warm_s,
             "warm_runs_s": warm_runs_s,
             "edges_traversed": st.edges_traversed,
             "gteps": st.edges_traversed / warm_s / 1e9,
             "kernel_launches": st.total_launches, "full_launches": st.full_launches,
             "compacted_launches": st.compacted_launches,
             "host_iterations": st.host_iterations,
             "frontier_masks": st.frontier_masks, "frontier_mask_s": st.frontier_mask_s,
             "resident_bytes": resident[name], "max_memory_allocated": peak[name],
             "oracle": agree})
    assert launches["shuffle_reduce"] > 0, "shuffle_reduce never launched on the main path"
    assert launches["edge_stream"] > 0, "edge_stream never launched on the main path"
    log({"phase": "main", "launches": launches})

    # -- where a warm run's time goes (outside the counted main path) -------
    for name in results:
        log({"phase": "profile", "program": name,
             **profile_run(lambda n=name: sessions[n].run(**params[n]))})
        log({"phase": "profile", "program": name, "shuffle_reduce_launches":
             shuffle_reduce_launches(sr, lambda n=name: sessions[n].run(**params[n]))})
    del sessions, eng, results
    gc.collect()
    torch.cuda.empty_cache()

    # -- 5. the LM path -------------------------------------------------------
    mods = (fa, md, get_config, Model, serve)
    kimi = lm_phase(mods, dev, args.seed)
    log(kimi)
    launches["flash_attention_sm90"] = kimi["launches"]["flash_attention_sm90"]
    launches["moe_gather"] = kimi["launches"]["moe_gather"]
    gc.collect()
    torch.cuda.empty_cache()
    qwen = qwen_phase(mods, dev, args.seed)
    log(qwen)
    launches["flash_attention"] = qwen["launches"]["flash_attention"]  # the f32 path
    gc.collect()
    torch.cuda.empty_cache()
    log(qwen_prefill_phase(mods, ref, dev, args.seed))

    # -- 6. summary ----------------------------------------------------------
    meta = {
        "shuffle_reduce": ("src/repro_torch/csrc/shuffle_reduce.cu",
                           "src/repro/kernels/shuffle_reduce.py:146"),
        "edge_stream": ("src/repro_torch/csrc/edge_stream.cu",
                        "src/repro/kernels/edge_stream.py:143"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:103"),
        "flash_attention_sm90": ("src/repro_torch/csrc/flash_attention_sm90.cu",
                                 "src/repro/kernels/flash_attention.py:103"),
        "moe_gather": ("src/repro_torch/csrc/moe_gather.cu",
                       "src/repro/kernels/moe_dispatch.py:72"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": row["max_abs_err"],
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "ok": True,
        })
        if "row_rel_check" in row:
            kernels[-1]["row_rel_err"] = row["row_rel_check"]["row_rel_err"]
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
