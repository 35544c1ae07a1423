"""The port's serving tier (``repro_torch.serve()``) held to the reference's.

The cases of the reference's serving tests, run against the port on the
CPU (``device="cpu"``):

* resolution picks a resident session, a warm on-disk artifact or a cold
  lowering; parallel submits lower once; a size-1 registry evicts without
  tearing down a pinned entry; a stale artifact is quarantined, not
  probed again;
* the scheduler sheds load with ``Overloaded``, fails expired requests
  with ``DeadlineExceeded`` and serves weighted tenants in proportion;
* every closed surface raises ``ServiceClosed``.

Beyond those: the port's service answers the eight programs as the
reference's service does (bit for bit, or within the float-sum tolerance
of PAGERANK, PPR and CGAW), its ``stats()`` has the reference's schema, a
resident entry binds its graph once for single and batched requests, and
a service without a device needs a GPU.
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.graph import generators as ref_generators
from repro_torch import GraphDelta, GraphShape, ServiceClosed, Target, generators
from repro_torch.algorithms import embedded, sources
from repro_torch.batch.dynamic import DynamicBatcher
from repro_torch.core.accelerator import accelerator_fingerprint
from repro_torch.core.program import compile_program
from repro_torch.serving import (
    ArtifactRegistry,
    DeadlineExceeded,
    GraphService,
    NAMED_ALGORITHMS,
    Overloaded,
    RequestScheduler,
    default_service,
    reset_default_service,
)
from repro_torch.serving.metrics import LatencyHistogram

TIMEOUT = 120  # every wait of this file is bounded


def _serve(store=False, **config):
    return repro_torch.serve(store, device="cpu", **config)


@pytest.fixture
def graph():
    return generators.uniform_random(200, 1200, seed=3)


@pytest.fixture
def bfs():
    return compile_program(sources.BFS_ECP)


def _levels(result):
    return np.asarray(result.properties["old_level"])


# ---------------------------------------------------------------------------
# registry: single-flight, eviction, quarantine
# ---------------------------------------------------------------------------


def test_parallel_acquire_single_flight(graph, bfs):
    reg = ArtifactRegistry(None, max_resident=4, device="cpu")
    entries, errors = [], []

    def worker():
        try:
            e = reg.acquire(bfs, graph, Target())
            entries.append(e)
            e.release()
        except BaseException as exc:  # pragma: no cover - diagnostic
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not errors
    assert reg.lowerings == 1
    assert len({id(e) for e in entries}) == 1
    assert entries[0].accelerator.binds == 1
    reg.close()


def test_parallel_service_submit_single_flight(graph, bfs, tmp_path):
    with _serve(str(tmp_path), workers=4, max_batch=1) as svc:
        futs = [svc.submit(bfs, graph, root=r) for r in range(8)]
        levels = [_levels(f.result(timeout=TIMEOUT)) for f in futs]
        assert svc.registry.lowerings == 1
    seq = bfs.bind(graph, device="cpu")
    for r, lvl in enumerate(levels):
        np.testing.assert_array_equal(lvl, seq.run(root=r).properties["old_level"])


def test_size1_eviction_keeps_inflight_safe(graph):
    with _serve(workers=2, max_batch=1, max_resident=1) as svc:
        futs = []
        for i in range(6):
            futs.append(svc.submit("bfs", graph, root=i))
            futs.append(svc.submit("pagerank", graph, iters=5 + i))
        results = [f.result(timeout=TIMEOUT) for f in futs]
        assert all(r is not None for r in results)
        stats = svc.stats()
        assert stats["queries"]["errors"] == 0
        assert stats["queries"]["completed"] == 12
        assert stats["registry"]["evictions"] >= 1
        assert stats["registry"]["resident"] <= 1


def test_stale_artifact_quarantined_not_retried(graph, bfs, tmp_path):
    store, target = str(tmp_path), Target()
    key = accelerator_fingerprint(bfs.fingerprint, target, GraphShape.of(graph))
    path = os.path.join(store, key[:24])

    reg = ArtifactRegistry(store, device="cpu")
    reg.acquire(bfs, graph, target).release()
    reg.close()
    assert os.path.isdir(path)
    with open(os.path.join(path, "program.gt"), "a") as f:
        f.write("\n// drift\n")

    reg2 = ArtifactRegistry(store, device="cpu")
    reg2.acquire(bfs, graph, target).release()
    snap = reg2.metrics.snapshot()["registry"]
    assert snap["quarantined"] == 1 and snap["artifact_hits"] == 0
    assert reg2.lowerings == 1
    assert os.path.isdir(path + ".quarantined")
    # a second miss in the same registry does not probe the store again
    reg2._accelerators.clear()
    reg2._residents.clear()
    reg2.acquire(bfs, graph, target).release()
    assert reg2.metrics.snapshot()["registry"]["quarantined"] == 1
    reg2.close()

    reg3 = ArtifactRegistry(store, device="cpu")
    reg3.acquire(bfs, graph, target).release()
    snap3 = reg3.metrics.snapshot()["registry"]
    assert snap3["artifact_hits"] == 1 and reg3.lowerings == 0
    reg3.close()


def test_reference_artifact_is_quarantined_not_loaded(graph, bfs, tmp_path):
    """A manifest the port cannot read (the reference's format) at the key's
    path is moved aside and lowered again, like any stale artifact."""
    store, target = str(tmp_path), Target()
    key = accelerator_fingerprint(bfs.fingerprint, target, GraphShape.of(graph))
    os.makedirs(os.path.join(store, key[:24]))
    with open(os.path.join(store, key[:24], "manifest.json"), "w") as f:
        json.dump({"format": 1, "substrate": "jax"}, f)
    reg = ArtifactRegistry(store, device="cpu")
    reg.acquire(bfs, graph, target).release()
    assert reg.metrics.snapshot()["registry"]["quarantined"] == 1
    assert reg.lowerings == 1
    reg.close()


# ---------------------------------------------------------------------------
# scheduler: admission control, deadlines, fairness
# ---------------------------------------------------------------------------


def _blocking_execute(started, release):
    def execute(job, param_sets):
        started.set()
        assert release.wait(timeout=30)
        return [dict(p) for p in param_sets]

    return execute


def test_overloaded_typed_rejection():
    started, release = threading.Event(), threading.Event()
    sched = RequestScheduler(_blocking_execute(started, release),
                             workers=1, max_batch=1, max_queue=2, max_wait_s=0.0)
    try:
        f0 = sched.submit("job", {"i": 0}, group_key="g")
        assert started.wait(timeout=10)
        f1 = sched.submit("job", {"i": 1}, group_key="g")
        f2 = sched.submit("job", {"i": 2}, group_key="g")
        with pytest.raises(Overloaded):
            sched.submit("job", {"i": 3}, group_key="g")
        assert sched.metrics.snapshot()["queries"]["rejected_overloaded"] == 1
        release.set()
        assert [f.result(timeout=10)["i"] for f in (f0, f1, f2)] == [0, 1, 2]
    finally:
        release.set()
        sched.close()


def test_deadline_exceeded_in_queue():
    started, release = threading.Event(), threading.Event()
    sched = RequestScheduler(_blocking_execute(started, release),
                             workers=1, max_batch=1, max_queue=8, max_wait_s=0.0)
    try:
        f0 = sched.submit("job", {"i": 0}, group_key="g")
        assert started.wait(timeout=10)
        f1 = sched.submit("job", {"i": 1}, group_key="g", deadline_s=0.05)
        with pytest.raises(DeadlineExceeded):
            f1.result(timeout=10)
        release.set()
        assert f0.result(timeout=10)["i"] == 0
        snap = sched.metrics.snapshot()
        assert snap["queries"]["rejected_deadline"] == 1
        assert snap["queries"]["completed"] == 1
    finally:
        release.set()
        sched.close()


def test_weighted_tenant_fairness():
    started, release = threading.Event(), threading.Event()
    order, lock = [], threading.Lock()

    def execute(job, param_sets):
        if job == "plug":
            started.set()
            assert release.wait(timeout=30)
        else:
            with lock:
                order.extend(p["tenant"] for p in param_sets)
        return [dict(p) for p in param_sets]

    sched = RequestScheduler(execute, workers=1, max_batch=1, max_queue=64, max_wait_s=0.0,
                             tenant_weights={"heavy": 3.0, "light": 1.0})
    try:
        plug = sched.submit("plug", {}, group_key="plug", tenant="warm")
        assert started.wait(timeout=10)
        futs = [sched.submit("q", {"tenant": "light"}, group_key="l", tenant="light")
                for _ in range(8)]
        futs += [sched.submit("q", {"tenant": "heavy"}, group_key="h", tenant="heavy")
                 for _ in range(8)]
        release.set()
        plug.result(timeout=10)
        for f in futs:
            f.result(timeout=30)
        first8 = order[:8]
        assert first8.count("heavy") >= 2 * first8.count("light")
    finally:
        release.set()
        sched.close()


def test_deadline_caps_batch_fill_wait():
    sched = RequestScheduler(lambda job, ps: [dict(p) for p in ps],
                             workers=1, max_batch=8, max_queue=8, max_wait_s=5.0)
    try:
        t0 = time.monotonic()
        f = sched.submit("job", {"i": 0}, group_key="g", deadline_s=0.1)
        assert f.result(timeout=10)["i"] == 0
        assert time.monotonic() - t0 < 2.0
    finally:
        sched.close()


# ---------------------------------------------------------------------------
# ServiceClosed: typed rejection from every closed surface
# ---------------------------------------------------------------------------


def test_service_closed_everywhere(graph, bfs):
    pool = bfs.pool(graph, size=1, device="cpu")
    pool.close()
    with pytest.raises(ServiceClosed):
        pool.submit(root=0)
    with pytest.raises(ServiceClosed):
        pool.run_batch([{"root": 0}])
    with pytest.raises(ServiceClosed):
        pool.refresh_graph()

    batcher = DynamicBatcher(lambda ps: ps, max_batch=2)
    batcher.close()
    with pytest.raises(ServiceClosed):
        batcher.submit({"root": 0})

    sched = RequestScheduler(lambda job, ps: ps, workers=1)
    sched.close()
    with pytest.raises(ServiceClosed):
        sched.submit("job", {}, group_key="g")

    svc = GraphService(False, workers=1, device="cpu")
    svc.close()
    assert svc.closed
    with pytest.raises(ServiceClosed):
        svc.submit("bfs", graph, root=0)
    with pytest.raises(ServiceClosed):
        svc.update("bfs", graph, GraphDelta())
    assert issubclass(ServiceClosed, repro_torch.SessionError)


# ---------------------------------------------------------------------------
# warm-path selection through the public surface
# ---------------------------------------------------------------------------


def test_submit_picks_resident_session(graph, tmp_path):
    with _serve(str(tmp_path), workers=1, max_batch=1) as svc:
        first = svc.run("bfs", graph, root=0)
        warm = svc.run("bfs", graph, root=1)
        assert first.stats.compile_time_s > 0  # a first touch of the lowering
        assert warm.stats.compile_time_s == 0.0
        reg = svc.stats()["registry"]
        assert reg["cold_lowerings"] == 1 and reg["resident_hits"] >= 1


def test_cross_service_warm_artifact(graph, tmp_path):
    with _serve(str(tmp_path), workers=1, max_batch=1) as svc:
        cold = svc.run("bfs", graph, root=0)
        assert svc.stats()["registry"]["cold_lowerings"] == 1
    with _serve(str(tmp_path), workers=1, max_batch=1) as svc2:
        first = svc2.run("bfs", graph, root=0)
        warm = svc2.run("bfs", graph, root=1)
        reg = svc2.stats()["registry"]
        assert reg["artifact_hits"] == 1 and reg["cold_lowerings"] == 0
        assert svc2.registry.lowerings == 0
        assert warm.stats.compile_time_s == 0.0
    np.testing.assert_array_equal(_levels(first), _levels(cold))


def test_run_one_shot_routes_through_default_service(graph, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_ARTIFACT_DIR", str(tmp_path))
    reset_default_service(device="cpu")
    try:
        first = repro_torch.run("bfs", graph, root=0)
        again = repro_torch.run("bfs", graph, root=0)
        np.testing.assert_array_equal(_levels(first), _levels(again))
        assert again.stats.compile_time_s == 0.0
        assert default_service().registry.lowerings == 1
        assert default_service().registry.store_dir == str(tmp_path)
        assert os.listdir(tmp_path)  # the artifact was saved to the store
    finally:
        reset_default_service()


def test_named_source_program_and_twin_share_one_entry(graph):
    with _serve(workers=1, max_batch=1) as svc:
        r0 = svc.run("bfs", graph, root=0)
        svc.run(sources.BFS_ECP, graph, root=1)
        svc.run(compile_program(sources.BFS_ECP), graph, root=2)
        twin = svc.run(embedded.BFS_ECP_EMBEDDED, graph, root=0)
        assert svc.registry.lowerings == 1
        assert svc.stats()["registry"]["resident_hits"] == 3
        (entry,) = svc.registry._residents.values()
        assert entry.accelerator.binds == 1
        np.testing.assert_array_equal(_levels(twin), _levels(r0))
        assert "bfs_ecp" in svc.stats()["programs"]  # the twin's label is its name


def test_submit_validates_params_on_caller(graph):
    with _serve(workers=1) as svc:
        with pytest.raises(repro_torch.ProgramError):
            svc.submit("bfs", graph, rooot=3)
        with pytest.raises(repro_torch.ProgramError):
            svc.submit("this is not a .gt program", graph)
    with pytest.raises(KeyError):
        NAMED_ALGORITHMS["not_an_algorithm_name"]


def test_distributed_backend_is_not_ported(graph):
    """The distributed backend serves: its registry keys on the distributed
    Target and its answers are a local service's; an unknown backend is
    refused when the service is made."""
    with pytest.raises(ValueError, match="Target.kind"):
        repro_torch.serve(False, backend="mesh", device="cpu")
    with _serve(backend="distributed", workers=1) as svc:
        assert svc.backend == "distributed"
        got = svc.submit("bfs", graph, root=3).result(timeout=TIMEOUT)
        assert [k[1].kind for k in svc.registry._residents] == ["distributed"]
    want = compile_program(sources.BFS_ECP).bind(graph, device="cpu").run(root=3)
    np.testing.assert_array_equal(_levels(got), _levels(want))
    assert got.stats.dist_supersteps > 0


def test_service_without_a_device_needs_a_gpu(graph):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device binds")
    with repro_torch.serve(False, workers=1) as svc:
        with pytest.raises(repro_torch.SessionError, match="no CUDA device"):
            svc.submit("bfs", graph, root=0).result(timeout=TIMEOUT)


def test_concurrent_submitters_stress(graph):
    """More submitting threads and workers than cores, a short switch
    interval: every request completes once, with its own answer, and the
    counters add up (a lost update in the scheduler, the registry or the
    metrics breaks one of them)."""
    import sys

    seq = {name: compile_program(NAMED_ALGORITHMS[name]).bind(graph, device="cpu")
           for name in ("bfs", "wcc")}
    want = {("bfs", r): seq["bfs"].run(root=r).properties["old_level"] for r in range(6)}
    want[("wcc", None)] = seq["wcc"].run().properties["comp"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    errors, done = [], []
    try:
        with _serve(workers=8, max_batch=4, max_queue=256) as svc:
            def client(i):
                try:
                    for j in range(6):
                        if (i + j) % 3:
                            f = svc.submit("bfs", graph, tenant=f"t{i % 3}", root=j)
                            done.append((("bfs", j), f))
                        else:
                            done.append((("wcc", None), svc.submit("wcc", graph)))
                except BaseException as exc:  # pragma: no cover - diagnostic
                    errors.append(exc)

            threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT)
            assert not any(t.is_alive() for t in threads) and not errors, errors
            for key, f in done:
                res = f.result(timeout=TIMEOUT)
                prop = "old_level" if key[0] == "bfs" else "comp"
                np.testing.assert_array_equal(res.properties[prop], want[key])
            snap = svc.stats()
            assert svc.scheduler.drain(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
    assert snap["queries"]["submitted"] == snap["queries"]["completed"] == len(done) == 72
    assert sum(t["completed"] for t in snap["tenants"].values()) == 72
    assert snap["batches"]["queries"] == 72
    assert svc.registry.lowerings == 2


# ---------------------------------------------------------------------------
# one bind per resident entry
# ---------------------------------------------------------------------------


def test_resident_entry_binds_once_for_single_and_batched(graph, bfs):
    reg = ArtifactRegistry(None, max_batch=4, device="cpu")
    entry = reg.acquire(bfs, graph, Target())
    try:
        single = entry.run({"root": 5})
        batched = entry.run_many([{"root": r} for r in range(6)])
        assert entry.accelerator.binds == 1
        # the batched twin runs on the session's engine, under its lock
        twin = entry.session._batch_session
        assert twin.engine.engine is entry.session.engine
        assert twin._lock is entry.session._lock
        assert twin.accelerator is entry.accelerator
        assert twin.runs == 2  # 6 queries in chunks of the registry's max_batch 4
        seq = bfs.bind(graph, device="cpu")
        for r, res in enumerate(batched):
            np.testing.assert_array_equal(_levels(res), seq.run(root=r).properties["old_level"])
        np.testing.assert_array_equal(_levels(single), seq.run(root=5).properties["old_level"])
        assert entry.bind_s > 0 and entry.queries == 7
    finally:
        entry.release()
        reg.close()


# ---------------------------------------------------------------------------
# streaming updates through the service
# ---------------------------------------------------------------------------


def test_service_update_bumps_version_in_place():
    base = generators.uniform_random(300, 1800, seed=5)
    shape = GraphShape.bucket_for(base.n_vertices, base.n_edges)
    g = base.pad_to(shape.n_vertices, shape.n_edges)
    rng = np.random.default_rng(7)
    with _serve(workers=1, max_batch=4) as svc:
        r0 = svc.run("bfs", g, root=0, tenant="v0")
        assert r0.version == 0
        svc.submit("bfs", g, root=1).result(timeout=TIMEOUT)
        pair = [svc.submit("bfs", g, root=r) for r in (2, 3)]
        [f.result(timeout=TIMEOUT) for f in pair]
        edges = rng.integers(0, base.n_vertices, size=(16, 2)).astype(np.int32)
        assert svc.update("bfs", g, GraphDelta(added_edges=edges)) == 1
        r1 = svc.run("bfs", g, root=0, tenant="v1")
        assert r1.version == 1 and r1.stats.compile_time_s == 0.0
        assert svc.registry.lowerings == 1
        fresh = compile_program(sources.BFS_ECP).bind(g, device="cpu")
        np.testing.assert_array_equal(_levels(r1), fresh.run(root=0).properties["old_level"])
        # a batched request after the update runs on the refreshed graph
        later = [svc.submit("bfs", g, root=r) for r in (4, 5, 6)]
        for r, f in zip((4, 5, 6), later):
            res = f.result(timeout=TIMEOUT)
            assert res.version == 1
            np.testing.assert_array_equal(_levels(res),
                                          fresh.run(root=r).properties["old_level"])


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def test_latency_histogram_is_the_tracers_one_copy():
    from repro_torch.telemetry import histogram

    assert LatencyHistogram is histogram.LatencyHistogram
    h = LatencyHistogram()
    for ms in range(1, 101):
        h.record(ms / 1e3)
    snap = h.snapshot()
    assert snap["count"] == 100
    assert 0.045 <= snap["p50_ms"] / 1e3 <= 0.075
    assert 0.09 <= snap["p99_ms"] / 1e3 <= 0.15
    assert snap["max_ms"] == 100.0
    assert LatencyHistogram().snapshot()["p99_ms"] == 0.0
    ref = repro.serving.metrics.LatencyHistogram()
    for ms in range(1, 101):
        ref.record(ms / 1e3)
    assert ref.snapshot() == snap


def test_stats_snapshot_is_json_per_tenant(graph):
    with _serve(workers=2, max_batch=4, tenant_weights={"a": 1.0, "b": 2.0}) as svc:
        futs = [svc.submit("bfs", graph, root=i, tenant="a", deadline_s=60.0)
                for i in range(3)]
        futs += [svc.submit("bfs", graph, root=i, tenant="b") for i in range(2)]
        for f in futs:
            f.result(timeout=TIMEOUT)
        snap = svc.stats()
    encoded = json.loads(json.dumps(snap))
    assert encoded["queries"]["submitted"] == 5
    assert encoded["queries"]["completed"] == 5
    assert encoded["queries"]["deadline_misses"] == 0
    assert encoded["tenants"]["a"]["submitted"] == 3
    assert encoded["tenants"]["b"]["submitted"] == 2
    assert encoded["programs"]["bfs"]["completed"] == 5
    assert encoded["tenants"]["a"]["latency_ms"]["p99_ms"] > 0
    assert encoded["batches"]["queries"] == 5
    assert 0 < encoded["batches"]["occupancy"] <= 1
    assert encoded["queue_depth"] == 0
    assert encoded["uptime_s"] >= 0


# ---------------------------------------------------------------------------
# parity with the reference's service on the eight programs
# ---------------------------------------------------------------------------

# name -> (parameter sets, float sums within tolerance)
PARITY = {
    "bfs": ([{"root": r} for r in (0, 7, 19)], False),
    "bfs_hybrid": ([{"root": r} for r in (0, 11)], False),
    "sssp": ([{"root": r} for r in (0, 5, 9)], False),
    "wcc": ([{}], False),
    "kcore": ([{"k": 2}, {"k": 3}], False),
    "pagerank": ([{"iters": 4}, {"iters": 9}], True),
    "ppr": ([{"source": 1, "max_iters": 6}, {"source": 4, "max_iters": 6}], True),
    "cgaw": ([{}], True),
}


@pytest.fixture(scope="module")
def parity_graphs():
    ref = ref_generators.uniform_random(240, 1500, weighted=True, seed=11)
    ours = repro_torch.graph_from_arrays(ref.n_vertices, ref.src, ref.dst, ref.weights)
    return ref, ours


@pytest.fixture(scope="module")
def services():
    ours = repro_torch.serve(False, device="cpu", workers=2, max_batch=4,
                             tenant_weights={"a": 2.0, "b": 1.0})
    theirs = repro.serve(False, workers=2, max_batch=4, tenant_weights={"a": 2.0, "b": 1.0})
    yield ours, theirs
    ours.close()
    theirs.close()


def _schema(x):
    """The nested key structure of a stats snapshot (leaves: their types)."""
    if isinstance(x, dict):
        return {k: _schema(v) for k, v in x.items()}
    return "number" if isinstance(x, (int, float)) and not isinstance(x, bool) \
        else type(x).__name__


@pytest.mark.parametrize("name", sorted(PARITY))
def test_served_answers_match_the_reference_service(name, parity_graphs, services):
    ref_g, g = parity_graphs
    ours, theirs = services
    param_sets, float_sums = PARITY[name]
    futs = [(ours.submit(name, g, tenant="ab"[i % 2], **p),
             theirs.submit(name, ref_g, tenant="ab"[i % 2], **p))
            for i, p in enumerate(param_sets)]
    seq = compile_program(NAMED_ALGORITHMS[name]).bind(g, device="cpu")
    for p, (f_ours, f_theirs) in zip(param_sets, futs):
        got, want = f_ours.result(timeout=TIMEOUT), f_theirs.result(timeout=TIMEOUT)
        assert set(got.properties) == set(want.properties)
        for prop, a in want.properties.items():
            a, b = np.asarray(a), np.asarray(got.properties[prop])
            assert b.dtype == a.dtype and b.shape == a.shape, prop
            if float_sums and a.dtype == np.float32:
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=prop)
            else:
                np.testing.assert_array_equal(b, a, err_msg=prop)
        # the service answers as a session of the same parameters does
        alone = seq.run(**p)
        for prop, a in alone.properties.items():
            np.testing.assert_array_equal(got.properties[prop], a, err_msg=prop)


def test_stats_schema_matches_the_reference_service(parity_graphs, services):
    ref_g, g = parity_graphs
    ours, theirs = services
    ours.run("bfs", g, tenant="a", root=1)
    theirs.run("bfs", ref_g, tenant="a", root=1)
    assert _schema(ours.stats()) == _schema(theirs.stats())
    assert ours.stats()["tuning"]["store_dir"] is None
