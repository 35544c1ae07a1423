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
   events.
4. Main path: ``repro_torch.compile(src).bind(g).run(**params)`` on the
   card for BFS_ECP, PAGERANK and SSSP (one cold run, then five warm
   runs whose median is the warm time), each checked
   against an independent numpy/scipy oracle, with both kernels' launch
   counters set to 0 before and read after. One more warm run of each
   program under ``torch.profiler`` then shows where its time goes: the
   device's busy and idle share and the kernels that took the most time.
5. The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SSSP_INF = 1073741823  # the SSSP program's INF
EDGE_FACTOR = 32  # edges per vertex of the paper's RMAT graphs (rmat-19-32)
WARM_RUNS = 5  # warm runs per program; warm_s is their median (host clocks vary)
PAGERANK_RTOL = 1e-4  # float32 engine vs float64 oracle after 20 iterations
PAGERANK_ATOL = 1e-10


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


def profile_run(sess, params: dict, top: int = 6) -> dict:
    """One more warm run under ``torch.profiler``: its wall time, the time
    the device was busy (kernel intervals merged), and the kernels that
    took the most device time. The profiler slows the host, so the idle
    share it gives is an upper bound of the unprofiled run's."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.run(**params)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
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
    return {
        "wall_s": wall_s, "device_kernels": len(kernels), "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_s if kernels else None,
        "top_kernels_ms": {name[:80]: us / 1e3 for name, us in top_k},
        "host_ops_s": sum(us for _, us in ops) / 1e6,
        "top_host_ops_ms": {name[:80]: us / 1e3 for name, us in top_ops},
    }


def bound(n_bytes: int, n_ops: int):
    """Least time the card could take: bytes over HBM rate vs operations
    over the float32 rate; returns (ms, which one bounds)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    vact = torch.rand(n_v, generator=gen, device=dev) < 0.5
    sp = torch.randint(0, 2**20, (n_v,), generator=gen, device=dev, dtype=torch.int32)
    w = weights
    got = es.edge_stream_gather(sp, vact, gb["es_src"], gb["es_eid"], w, offsets, "add", "min")
    want = ref.edge_stream_gather_ref(sp, vact, gb["es_src"], gb["es_eid"], w, offsets,
                                      "add", "min")
    err_i = check_equal("edge_stream main-shape i32 add min", got, want, "min")
    n_active = int(vact[gb["es_src"]].sum())
    b_ms, b_by = bound(4 * n_e + 8 * n_active + 5 * n_v + 8 * n_out + 4, 2 * n_active)
    rows["edge_stream"] = {
        "kernel_ms": time_ms(lambda: es.edge_stream_gather(
            sp, vact, gb["es_src"], gb["es_eid"], w, offsets, "add", "min")),
        "plain_ms": time_ms(lambda: ref.edge_stream_gather_ref(
            sp, vact, gb["es_src"], gb["es_eid"], w, offsets, "add", "min"), iters=5),
        "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err_i,
        "shape": {"edges": n_e, "bins": n_out, "dtype": "int32", "apply": "add",
                  "op": "min", "active_edges": n_active},
    }
    rank = torch.rand(n_v, generator=gen, device=dev)
    got = es.edge_stream_gather(rank, vact, gb["es_src"], None, None, offsets, "src", "+")
    again = es.edge_stream_gather(rank, vact, gb["es_src"], None, None, offsets, "src", "+")
    assert torch.equal(got.view(torch.int32), again.view(torch.int32)), \
        "edge_stream: float + differs between two runs"
    want = ref.edge_stream_gather_ref(rank, vact, gb["es_src"], None, None, offsets, "src", "+")
    upd = torch.where(vact, rank, 0.0)[gb["es_src"]]
    err_f = check_equal("edge_stream main-shape f32 src +", got, want, "+",
                        f32_sum_tolerance(upd, ids, n_out))
    b_ms, b_by = bound(4 * n_e + 5 * n_v + 8 * n_out + 4, n_e)
    rows["edge_stream_f32"] = {
        "kernel_ms": time_ms(lambda: es.edge_stream_gather(
            rank, vact, gb["es_src"], None, None, offsets, "src", "+")),
        "plain_ms": time_ms(lambda: ref.edge_stream_gather_ref(
            rank, vact, gb["es_src"], None, None, offsets, "src", "+"), iters=5),
        "library_ms": None,
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err_f,
        "shape": {"edges": n_e, "bins": n_out, "dtype": "float32", "apply": "src", "op": "+"},
    }
    return rows


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
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import edge_stream as es
    from repro_torch.kernels import shuffle_reduce as sr

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
        log({"phase": "profile", "program": name, **profile_run(sessions[name], params[name])})

    # -- 5. summary ----------------------------------------------------------
    meta = {
        "shuffle_reduce": ("src/repro_torch/csrc/shuffle_reduce.cu",
                           "src/repro/kernels/shuffle_reduce.py:146"),
        "edge_stream": ("src/repro_torch/csrc/edge_stream.cu",
                        "src/repro/kernels/edge_stream.py:143"),
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
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
