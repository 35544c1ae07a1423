"""The port's batched queries against its own sequential runs and the reference.

The cases of ``tests/test_batch.py``, less the distributed backend and the
embedded front end, which the port does not have yet. On the CPU, where
the kernel wrappers take their plain PyTorch versions:

* every lane of ``bind_batch(g, device="cpu").run_many(ps)`` is
  **bit-identical** to a sequential ``bind(g, device="cpu").run(**p)`` of
  the port (properties and host scalars);
* the port's batched run meets the parity contract against the
  reference's own ``bind_batch(g).run_many(ps)`` on the same seeded inputs:
  bit-exact for BFS_ECP, BFS_HYBRID, SSSP, WCC and KCORE, ``rtol=1e-5,
  atol=1e-6`` for PAGERANK, PPR and CGAW (float sums in another order),
  ``host_env`` and the launch accounting equal;
* the batched kernel wrappers match the reference's
  ``ops.shuffle_reduce_batched``/``ops.edge_stream_batched`` (Pallas,
  interpret mode) and K one-row calls of the port's plain versions, and the
  bitwise-OR reduce matches numpy's ``bitwise_or.reduceat``.

The CUDA kernels' batched launches are held to one-row launches on the
card in ``tests/test_torch_gpu.py``.
"""
import re
import threading

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.algorithms import sources as ref_sources
from repro.batch import match_msbfs as ref_match_msbfs
from repro.graph import generators as ref_generators
from repro.kernels import ops as ref_ops
from repro_torch.algorithms import sources
from repro_torch.batch import BatchEngine, DynamicBatcher, match_msbfs
from repro_torch.core import CompileOptions, ProgramError, ServiceClosed, SessionError
from repro_torch.kernels import _build, ref
from repro_torch.kernels import edge_stream as es
from repro_torch.kernels import shuffle_reduce as sr

PASSES_OFF = CompileOptions(passes="none")
FLOAT_SUMS = {"pagerank", "ppr", "cgaw"}

# algorithm -> (source name, param maker: rng, k -> list of param dicts)
ALGORITHMS = {
    "bfs": ("BFS_ECP", lambda rng, k: [{"root": int(r)} for r in rng.integers(0, 200, k)]),
    "bfs_hybrid": ("BFS_HYBRID",
                   lambda rng, k: [{"root": int(r)} for r in rng.integers(0, 200, k)]),
    "pagerank": ("PAGERANK", lambda rng, k: [{"iters": int(i)} for i in rng.integers(2, 8, k)]),
    "sssp": ("SSSP", lambda rng, k: [{"root": int(r)} for r in rng.integers(0, 200, k)]),
    "ppr": ("PPR", lambda rng, k: [{"source": int(s), "max_iters": 12}
                                   for s in rng.integers(0, 200, k)]),
    "cgaw": ("CGAW", lambda rng, k: [{} for _ in range(k)]),
    "wcc": ("WCC", lambda rng, k: [{} for _ in range(k)]),
    "kcore": ("KCORE", lambda rng, k: [{"k": int(v)} for v in rng.integers(2, 5, k)]),
}


@pytest.fixture(scope="module")
def graphs():
    g = ref_generators.power_law(200, 1400, seed=5, weighted=True)
    return g, repro_torch.graph_from_arrays(g.n_vertices, g.src, g.dst, g.weights,
                                            n_vertices_logical=g.n_vertices_logical,
                                            n_edges_logical=g.n_edges_logical)


@pytest.fixture(scope="module")
def graph(graphs):
    return graphs[1]


def _compile(algo, passes="default"):
    return repro_torch.compile(getattr(sources, ALGORITHMS[algo][0]),
                               CompileOptions(passes=passes))


def assert_results_identical(seq, bat, ctx=""):
    assert len(seq) == len(bat)
    for i, (a, b) in enumerate(zip(seq, bat)):
        assert set(a.properties) == set(b.properties), f"{ctx}[{i}]"
        for name, want in a.properties.items():
            got = b.properties[name]
            assert got.dtype == want.dtype and got.shape == want.shape, f"{ctx}[{i}].{name}"
            assert np.array_equal(want.view(np.uint8), got.view(np.uint8)), (
                f"{ctx}[{i}].{name} not bit-identical to the sequential run")
        assert a.host_env == b.host_env, f"{ctx}[{i}] host scalars"


def assert_parity(algo, want, got, ctx=""):
    """The port's batched results against the reference's: the parity
    contract (ROADMAP), lane by lane, and the batch's launch accounting."""
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        assert set(a.properties) == set(b.properties), f"{ctx}[{i}]"
        for prop, x in a.properties.items():
            y = b.properties[prop]
            assert y.dtype == x.dtype and y.shape == x.shape, f"{ctx}[{i}].{prop}"
            if algo in FLOAT_SUMS and x.dtype == np.float32:
                np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-6, err_msg=f"{ctx}.{prop}")
            else:
                np.testing.assert_array_equal(y, x, err_msg=f"{ctx}.{prop}")
        assert b.host_env == a.host_env, f"{ctx}[{i}] host scalars"
    ws, gs = want[0].stats, got[0].stats
    assert gs.kernel_launches == ws.kernel_launches
    assert (gs.full_launches, gs.fused_launches, gs.edges_traversed, gs.host_iterations,
            gs.batch_size) == (ws.full_launches, ws.fused_launches, ws.edges_traversed,
                               ws.host_iterations, ws.batch_size)


def _reference_batch(graphs, algo, sets, passes="default"):
    prog = repro.compile(getattr(ref_sources, ALGORITHMS[algo][0]),
                         repro.CompileOptions(passes=passes))
    return prog.bind_batch(graphs[0]).run_many(sets)


# ---------------------------------------------------------------------------
# equivalence matrix: every algorithm x passes, K = 8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", list(ALGORITHMS))
@pytest.mark.parametrize("passes", ["default", "none"], ids=["passes_on", "passes_off"])
def test_batched_equivalence_matrix(graphs, algo, passes):
    prog = _compile(algo, passes)
    sets = ALGORITHMS[algo][1](np.random.default_rng(7), 8)
    sess = prog.bind(graphs[1], device="cpu")
    seq = [sess.run(**p) for p in sets]
    bat = prog.bind_batch(graphs[1], device="cpu").run_many(sets)
    assert_results_identical(seq, bat, f"{algo}/{passes}")
    assert_parity(algo, _reference_batch(graphs, algo, sets, passes), bat, f"{algo}/{passes}")


@pytest.mark.parametrize("algo", list(ALGORITHMS))
@pytest.mark.parametrize("target", ["baseline", "partition16", "nocache", "nocompact"])
def test_batched_matches_sequential_under_other_targets(graph, algo, target):
    """The knob points the sequential engine branches on: no shuffle (plain
    scatters), many dst partitions, no hub relabel, no compaction."""
    tgt = {"baseline": repro_torch.Target.baseline(),
           "partition16": repro_torch.Target(partition_vertices=16),
           "nocache": repro_torch.Target(cache=False),
           "nocompact": repro_torch.Target(compact_frontier=False)}[target]
    prog = _compile(algo)
    sets = ALGORITHMS[algo][1](np.random.default_rng(3), 5)
    sess = prog.bind(graph, target=tgt, device="cpu")
    seq = [sess.run(**p) for p in sets]
    bat = prog.bind_batch(graph, target=tgt, device="cpu").run_many(sets)
    assert_results_identical(seq, bat, f"{algo}/{target}")


# ---------------------------------------------------------------------------
# K sweep (K in {1, 8, 64}; 33 crosses a packed word on the MS-BFS path)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["bfs", "pagerank"])
@pytest.mark.parametrize("k", [1, 8, 33, 64])
def test_batched_k_sweep(graphs, algo, k):
    prog = _compile(algo)
    sets = ALGORITHMS[algo][1](np.random.default_rng(k), k)
    sess = prog.bind(graphs[1], device="cpu")
    seq = [sess.run(**p) for p in sets]
    bat = prog.bind_batch(graphs[1], device="cpu").run_many(sets)
    assert_results_identical(seq, bat, f"{algo}/K={k}")
    assert bat[0].stats.batch_size == k
    assert (BatchEngine.MSBFS_NAME in bat[0].stats.kernel_launches) == (algo == "bfs")
    assert_parity(algo, _reference_batch(graphs, algo, sets), bat, f"{algo}/K={k}")


def test_batched_bfs_generic_path_matches_msbfs(graph):
    """msbfs=False forces the generic batched path onto BFS: same results."""
    prog = _compile("bfs")
    sets = [{"root": int(r)} for r in np.random.default_rng(1).integers(0, 200, 8)]
    fast = prog.bind_batch(graph, device="cpu").run_many(sets)
    generic = prog.bind_batch(graph, device="cpu", msbfs=False).run_many(sets)
    assert_results_identical(fast, generic, "msbfs-vs-generic")
    assert BatchEngine.MSBFS_NAME in fast[0].stats.kernel_launches
    assert BatchEngine.MSBFS_NAME not in generic[0].stats.kernel_launches


def test_msbfs_level_step_is_one_or_launch_per_level(graph, monkeypatch):
    """Each level is one edge_stream_gather_batched call: the words as
    rows, apply 'src', reduce '|' (the plain version runs on the CPU)."""
    calls = []
    inner = es.edge_stream_gather_batched

    def recording(vval, vact, src_s, eid_s, weights, offsets, apply_op, reduce_op, split=None):
        calls.append((tuple(vval.shape), vval.dtype, apply_op, reduce_op))
        return inner(vval, vact, src_s, eid_s, weights, offsets, apply_op, reduce_op, split)

    monkeypatch.setattr(es, "edge_stream_gather_batched", recording)
    sets = [{"root": int(r)} for r in np.random.default_rng(5).integers(0, 200, 40)]
    bat = _compile("bfs").bind_batch(graph, device="cpu").run_many(sets)
    assert len(calls) == bat[0].stats.kernel_launches[BatchEngine.MSBFS_NAME]
    assert set(calls) == {((2, graph.n_vertices), torch.int32, "src", "|")}


# ---------------------------------------------------------------------------
# MS-BFS template selection
# ---------------------------------------------------------------------------


def test_msbfs_matches_bfs_template():
    for opts in (CompileOptions(), PASSES_OFF):
        plan = match_msbfs(repro_torch.compile(sources.BFS_ECP, opts).module)
        assert plan is not None, f"BFS template should match (passes={opts.passes})"
        assert plan.level_prop == "old_level"
        assert plan.next_prop == "new_level"
        assert plan.tuple_prop == "tuple"
        assert plan.counter_prop == "activeVertex"
        assert plan.root_scalar == "root"
        assert plan.inf == 2147483647
        want = ref_match_msbfs(repro.compile(ref_sources.BFS_ECP,
                                             repro.CompileOptions(passes=opts.passes)).module)
        assert plan.__dict__ == want.__dict__


def test_msbfs_rejects_non_bfs_programs():
    # hybrid BFS: the direction-switching host `if` breaks the template
    for name in ("BFS_HYBRID", "PAGERANK", "SSSP", "PPR", "CGAW", "WCC", "KCORE"):
        assert match_msbfs(repro_torch.compile(getattr(sources, name)).module) is None, name


def test_msbfs_declines_when_level_param_overridden(graph):
    """Binding `level` explicitly leaves the template (level must start at
    1): the generic path runs, still bit-identical."""
    prog = _compile("bfs")
    sets = [{"root": 3, "level": 1}, {"root": 9, "level": 1}]
    sess = prog.bind(graph, device="cpu")
    seq = [sess.run(**p) for p in sets]
    bat = prog.bind_batch(graph, device="cpu").run_many(sets)
    assert_results_identical(seq, bat, "level-override")
    assert BatchEngine.MSBFS_NAME not in bat[0].stats.kernel_launches


# ---------------------------------------------------------------------------
# launch sublinearity (<= 0.25 * K x sequential at K = 64)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("msbfs", [True, False], ids=["msbfs", "generic"])
def test_bfs_launch_sublinearity_at_k64(graph, msbfs):
    prog = _compile("bfs")
    roots = [{"root": int(r)} for r in np.random.default_rng(2).integers(0, 200, 64)]
    sess = prog.bind(graph, device="cpu")
    seq_total = sum(sess.run(**p).stats.total_launches for p in roots)
    bat = prog.bind_batch(graph, device="cpu", msbfs=msbfs).run_many(roots)
    assert bat[0].stats.total_launches <= 0.25 * seq_total, (
        f"batched BFS used {bat[0].stats.total_launches} launches vs {seq_total} sequential")


def test_pagerank_launch_sublinearity(graph):
    prog = _compile("pagerank")
    sets = [{"iters": 6}] * 16
    sess = prog.bind(graph, device="cpu")
    seq_total = sum(sess.run(**p).stats.total_launches for p in sets)
    bat = prog.bind_batch(graph, device="cpu").run_many(sets)
    # identical iteration counts: the batch needs exactly 1/16th the launches
    assert bat[0].stats.total_launches * 16 == seq_total


# ---------------------------------------------------------------------------
# EngineStats batch accounting
# ---------------------------------------------------------------------------


def test_stats_batch_size_and_per_query(graph):
    prog = _compile("pagerank")
    seq = prog.bind(graph, device="cpu").run(iters=4)
    assert seq.stats.batch_size == 1
    assert seq.stats.per_query_launches == seq.stats.total_launches
    bat = prog.bind_batch(graph, device="cpu").run_many([{"iters": 4}] * 8)
    stats = bat[0].stats
    assert stats.batch_size == 8
    # all results of one batch share one stats object: per-batch counters
    assert all(r.stats is stats for r in bat)
    assert stats.per_query_launches == stats.total_launches / 8


def test_warm_keys_split_cold_and_warm_batches(graph):
    bs = _compile("pagerank").bind_batch(graph, device="cpu")
    bs.run_many([{"iters": 3}] * 4)
    keys = {k for k in bs.engine.engine._warm_keys if k[0] == "batched"}
    assert keys and all(k[2] == 4 for k in keys)
    assert bs.run_many([{"iters": 3}] * 4)[0].stats.compile_time_s == 0.0
    bs.run_many([{"iters": 3}] * 5)
    assert any(k[0] == "batched" and k[2] == 5 for k in bs.engine.engine._warm_keys)


# ---------------------------------------------------------------------------
# Session.run_many rerouting
# ---------------------------------------------------------------------------


def test_run_many_reroutes_eligible_sets(graph):
    prog = _compile("pagerank")
    sess = prog.bind(graph, device="cpu")
    sets = [{"iters": int(i)} for i in (3, 5, 7, 9)]
    seq = [prog.bind(graph, device="cpu").run(**p) for p in sets]
    got = sess.run_many(sets)
    assert sess._batch_session is not None, "eligible list should batch"
    assert_results_identical(seq, got, "run_many")
    assert got[0].stats.batch_size == 4


def test_run_many_falls_back_on_mixed_signatures(graph):
    prog = _compile("pagerank")
    sess = prog.bind(graph, device="cpu")
    sets = [{"iters": 3}, {"damp": 0.9}]  # different key sets
    got = sess.run_many(sets)
    assert sess._batch_session is None, "mixed signatures must not batch"
    assert got[0].stats.batch_size == 1
    seq = [prog.bind(graph, device="cpu").run(**p) for p in sets]
    assert_results_identical(seq, got, "run_many-mixed")


def test_run_many_batched_flag(graph):
    prog = _compile("pagerank")
    sess = prog.bind(graph, device="cpu")
    sets = [{"iters": 3}, {"iters": 4}]
    forced_seq = sess.run_many(sets, batched=False)
    assert forced_seq[0].stats.batch_size == 1
    forced_bat = sess.run_many(sets, batched=True)
    assert forced_bat[0].stats.batch_size == 2
    assert_results_identical(forced_seq, forced_bat, "batched-flag")
    with pytest.raises(SessionError):
        sess.run_many([{"iters": 3}, {"damp": 0.9}], batched=True)


def test_batch_session_validation(graph):
    prog = _compile("pagerank")
    bs = prog.bind_batch(graph, device="cpu")
    assert bs.run_many([]) == []
    with pytest.raises(ProgramError):
        bs.run_many([{"nope": 1}])
    with pytest.raises(SessionError):
        bs.run_many([{"iters": 3}, {"damp": 0.9}])
    with pytest.raises(SessionError, match="max_batch"):
        prog.bind_batch(graph, device="cpu", max_batch=0)


def test_bind_batch_and_pool_need_a_gpu_unless_cpu(graph, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog = _compile("bfs")
    for make in (lambda: prog.bind_batch(graph), lambda: prog.pool(graph),
                 lambda: prog.bind_batch(graph, device="cuda")):
        with pytest.raises(SessionError, match="no CUDA device"):
            make()
    assert prog.bind_batch(graph, device="cpu").device == "cpu"


def test_bind_batch_max_batch_chunks(graph):
    prog = _compile("pagerank")
    bs = prog.bind_batch(graph, device="cpu", max_batch=3)
    got = bs.run_many([{"iters": 4}] * 7)  # 3 + 3 + 1
    assert len(got) == 7
    assert bs.runs == 3 and bs.queries == 7
    assert sorted({r.stats.batch_size for r in got}) == [1, 3]


# ---------------------------------------------------------------------------
# SessionPool: rerouting, concurrency, dynamic batch collector
# ---------------------------------------------------------------------------


def test_pool_run_batch_reroutes(graph):
    prog = _compile("pagerank")
    sets = [{"iters": int(i)} for i in (3, 4, 5, 6)]
    seq = [prog.bind(graph, device="cpu").run(**p) for p in sets]
    with prog.pool(graph, size=2, device="cpu") as pool:
        got = pool.run_batch(sets)
    assert_results_identical(seq, got, "pool-batched")
    assert got[0].stats.batch_size == 4
    with prog.pool(graph, size=2, device="cpu") as pool:
        got_seq = pool.run_batch(sets, batched=False)
    assert_results_identical(seq, got_seq, "pool-sequential")
    assert got_seq[0].stats.batch_size == 1
    with pytest.raises(ServiceClosed):
        pool.submit(iters=3)


def test_pool_concurrent_submit_thread_safety(graph):
    """Hammer acquire/release from many threads; every result must match
    its own dedicated sequential run."""
    prog = _compile("pagerank")
    iters = [2 + (i % 5) for i in range(24)]
    want = {it: prog.bind(graph, device="cpu").run(iters=it) for it in sorted(set(iters))}
    with prog.pool(graph, size=3, device="cpu") as pool:
        pool.warmup(iters=2)
        results = [None] * len(iters)
        errors = []

        def worker(i):
            try:
                results[i] = pool.submit(iters=iters[i]).result(timeout=120)
            except Exception as exc:  # pragma: no cover - failure reporting
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(iters))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
    assert not errors
    for i, it in enumerate(iters):
        assert results[i] is not None
        assert np.array_equal(results[i].properties["rank"], want[it].properties["rank"])


def test_pool_dynamic_batcher_non_multiple_batch(graph):
    """batch=4 with 10 concurrent queries: the collector forms partial
    batches as needed and every Future resolves to the right answer."""
    prog = _compile("pagerank")
    iters = [2 + (i % 3) for i in range(10)]
    want = {it: prog.bind(graph, device="cpu").run(iters=it) for it in sorted(set(iters))}
    with prog.pool(graph, size=2, device="cpu", batch=4, batch_wait_s=0.05) as pool:
        futures = [pool.submit(iters=it) for it in iters]
        results = [f.result(timeout=180) for f in futures]
        stats = pool.batch_stats
    assert stats is not None
    assert stats.queries == 10
    assert sum(stats.sizes) == 10
    assert all(1 <= s <= 4 for s in stats.sizes)
    assert 0.0 < stats.occupancy <= 1.0
    for it, res in zip(iters, results):
        assert np.array_equal(res.properties["rank"], want[it].properties["rank"])
        assert res.host_env["iters"] == it


def test_dynamic_batcher_splits_mixed_signatures():
    """One batch = one parameter signature; mixed streams split batches."""
    calls = []

    def run_many(param_sets):
        keys = {frozenset(p) for p in param_sets}
        assert len(keys) == 1, "batcher handed down a mixed batch"
        calls.append(len(param_sets))
        return [dict(p) for p in param_sets]

    b = DynamicBatcher(run_many, max_batch=8, max_wait_s=0.05)
    futs = [b.submit({"root": i}) for i in range(3)]
    futs += [b.submit({"iters": i}) for i in range(2)]
    futs += [b.submit({"root": 9})]
    out = [f.result(timeout=60) for f in futs]
    b.close()
    assert out[0] == {"root": 0} and out[3] == {"iters": 0} and out[5] == {"root": 9}
    assert sum(calls) == 6


def test_dynamic_batcher_propagates_errors():
    def run_many(param_sets):
        raise ValueError("boom")

    b = DynamicBatcher(run_many, max_batch=4, max_wait_s=0.01)
    fut = b.submit({"x": 1})
    with pytest.raises(ValueError):
        fut.result(timeout=60)
    b.close()
    with pytest.raises(ServiceClosed):
        b.submit({"x": 2})


# ---------------------------------------------------------------------------
# the batched kernel wrappers and the bitwise-OR reduce (plain versions)
# ---------------------------------------------------------------------------


def _rows_of_one_row_calls(fn, k):
    return torch.stack([fn(q) for q in range(k)])


def test_shuffle_reduce_batched_matches_reference_and_one_row_calls():
    """test_batch.py's cases: per-row and shared indices; exact for min/max
    and int32 +, float + allclose to the reference (it sums in another
    order) and bit-identical to the port's own one-row calls."""
    rng = np.random.default_rng(0)
    k, n, n_out = 4, 300, 64
    vals = rng.normal(size=(k, n)).astype(np.float32)
    ivals = rng.integers(-50, 50, (k, n)).astype(np.int32)
    idx = rng.integers(0, n_out, (k, n)).astype(np.int32)
    t = torch.from_numpy
    cases = [(vals, idx, "min"), (vals, idx, "max"), (ivals, idx, "+"), (vals, idx[0], "+"),
             (ivals, idx[0], "max")]
    for v, ix, op in cases:
        got = sr.shuffle_reduce_batched(t(v), t(ix), n_out, op)
        want = np.asarray(ref_ops.shuffle_reduce_batched(v, ix, n_out, op, interpret=True))
        if v.dtype == np.float32 and op == "+":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got.numpy(), want)
        rows = _rows_of_one_row_calls(
            lambda q: sr.shuffle_reduce(t(v[q]), t(ix if ix.ndim == 1 else ix[q]), n_out, op), k)
        assert torch.equal(got.view(torch.int32), rows.view(torch.int32)), op


def test_per_row_route_drops_out_of_range_indices():
    """A per-row index outside [0, n_out) is dropped, never spilled into the
    next row's bins."""
    vals = torch.ones(2, 3, dtype=torch.int32)
    idx = torch.tensor([[0, 2, 5], [-1, 1, 1]], dtype=torch.int32)
    got = sr.shuffle_reduce_batched(vals, idx, 2, "+")
    assert got.tolist() == [[1, 0], [0, 2]]


def test_edge_stream_batched_matches_reference_and_one_row_calls():
    rng = np.random.default_rng(1)
    k, n, n_out = 3, 400, 64
    sv = rng.normal(size=(k, n)).astype(np.float32)
    w = rng.normal(size=(n,)).astype(np.float32)
    dst = rng.integers(0, n_out, (n,)).astype(np.int32)
    act = rng.integers(0, 2, (n,)).astype(bool)
    t = torch.from_numpy
    for red in ("min", "max", "+"):
        got = es.edge_stream_batched(t(sv), t(w), t(dst), t(act), n_out, "add", red)
        want = np.asarray(ref_ops.edge_stream_batched(sv, w, dst, act, n_out, "add", red))
        if red == "+":
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got.numpy(), want)
        rows = _rows_of_one_row_calls(
            lambda q: es.edge_stream(t(sv[q]), t(w), t(dst), t(act), n_out, "add", red), k)
        assert torch.equal(got.view(torch.int32), rows.view(torch.int32)), red


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("apply_op", ["add", "mul", "src"])
def test_batched_gather_rows_equal_one_row_calls(dtype, apply_op):
    """The fused-gather form over shared edges and offsets: per-row vertex
    values, the mask shared or per row, weights shared (stride 0) or per
    row; and the sorted shuffle_reduce with a row stride of 0."""
    gen = torch.Generator().manual_seed(4)
    k, n_v, n_e, n_out = 5, 50, 700, 40
    vval = torch.randint(-9, 9, (k, n_v), generator=gen).to(dtype)
    vact = torch.rand(k, n_v, generator=gen) < 0.6
    src_s = torch.randint(0, n_v, (n_e,), generator=gen, dtype=torch.int32)
    eid_s = torch.randperm(n_e, generator=gen).to(torch.int32)
    w = torch.randint(-5, 5, (k, n_e), generator=gen).to(dtype)
    offsets = sr.bin_offsets(torch.sort(torch.randint(0, n_out, (n_e,), generator=gen,
                                                      dtype=torch.int32))[0], n_out)
    ops = ("+", "min", "max") + (("|",) if dtype == torch.int32 else ())
    for op in ops:
        for act, ww in ((vact, w), (vact[0], w[0]), (vact[0].expand(k, -1), w[0].expand(k, -1))):
            got = es.edge_stream_gather_batched(vval, act, src_s, eid_s, ww, offsets, apply_op,
                                                op)
            rows = _rows_of_one_row_calls(lambda q: es.edge_stream_gather(
                vval[q], act if act.dim() == 1 else act[q], src_s, eid_s,
                ww if ww.dim() == 1 else ww[q], offsets, apply_op, op), k)
            assert torch.equal(got, rows), (op, act.shape, ww.shape)
        shared = vval[0, src_s.long()].expand(k, -1)
        got = sr.shuffle_reduce_sorted_batched(shared, offsets, n_out, op)
        assert torch.equal(got, sr.shuffle_reduce_sorted(shared[0], offsets, n_out, op)
                           .expand(k, -1)), op


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_or_reduce_matches_numpy_reduceat(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 6, 80)
    counts[[3, 9]] = 0  # empty bins hold the identity, 0
    n = int(counts.sum())
    vals = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    want = np.zeros(counts.shape[0], np.int32)
    nz = counts > 0
    want[nz] = np.bitwise_or.reduceat(vals, offsets[:-1][nz])
    got = sr.shuffle_reduce_sorted(torch.from_numpy(vals), torch.from_numpy(offsets),
                                   counts.shape[0], "|")
    np.testing.assert_array_equal(got.numpy(), want)
    idx = np.repeat(np.arange(counts.shape[0], dtype=np.int32), counts)
    perm = rng.permutation(n)
    got = sr.shuffle_reduce(torch.from_numpy(vals[perm]), torch.from_numpy(idx[perm]),
                            counts.shape[0], "|")
    np.testing.assert_array_equal(got.numpy(), want)


def test_or_reduce_takes_int32_only():
    off = torch.tensor([0, 2], dtype=torch.int32)
    for fn in (lambda: sr.shuffle_reduce_sorted(torch.ones(2), off, 1, "|"),
               lambda: sr.shuffle_reduce_sorted_batched(torch.ones(2, 2), off, 1, "|"),
               lambda: es.edge_stream_gather(torch.ones(2), torch.ones(2, dtype=torch.bool),
                                             torch.zeros(2, dtype=torch.int32), None, None,
                                             off, "src", "|")):
        with pytest.raises(TypeError, match="int32"):
            fn()
    assert ref.identity("|", torch.int32) == 0


@pytest.mark.parametrize("source,entry,wrapper", [
    ("shuffle_reduce", "repro_shuffle_reduce", sr._ARGTYPES),
    ("edge_stream", "repro_edge_stream", es._ARGTYPES),
])
def test_c_entry_points_take_the_wrappers_arguments(source, entry, wrapper):
    """The wrappers' ctypes argument lists match the C signatures (which
    gained the row count and row strides) one for one, in kind."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text).group(1).split(",")
    assert len(params) == len(wrapper)
    for p, t in zip(params, wrapper):
        kind = "ptr" if "*" in p else ("i64" if "int64_t" in p else "int")
        want = {"ptr": "c_void_p", "i64": "c_long", "int": "c_int"}[kind]
        assert t.__name__ in (want, "c_longlong" if kind == "i64" else want), (p, t)
