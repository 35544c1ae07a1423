"""The port's distributed graph engine against the reference package.

``Target(kind="distributed", n_devices=D)`` on the CPU: every shard is
``"cpu"`` (the counterpart of the reference's forced host device count),
and the kernel wrappers take their plain versions. Graphs are made from
numpy seeds by the reference's generators and carried across with
``graph_from_arrays``.

* ``partition_graph`` holds exactly the reference's buckets, pair by pair
  and in order, at D in {1, 2, 4, 8} (the reference's function reads only
  ``mesh.shape[axis]``, so it gets a stand-in object with that shape).
* ``make_push_step`` with ``+`` and ``min`` meets the numpy
  ``add.at``/``minimum.at`` oracle of ``tests/test_distributed.py``.
* All eight programs, passes default/none x D x ``Target()`` and
  ``Target.baseline()`` (each with the distributed kind), meet the parity
  contract against the port's local run, the reference's local run and the
  reference's ``backend="distributed"`` at its in-process one-device mesh:
  BFS_ECP, BFS_HYBRID, SSSP, WCC, KCORE bit-exact; PAGERANK, PPR, CGAW
  ``rtol=1e-5, atol=1e-6``; ``host_env`` and ``kernel_launches`` equal,
  ``dist_supersteps`` equal to the reference's.
* Batched runs, fused pipelines, the lazy accelerator and its round trip,
  streaming repairs, the served answers, the CLI and the span tree, each
  the port's twin of a reference case.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.algorithms import sources as ref_sources
from repro.core import dist_engine as ref_dist
from repro.core.accelerator import GraphShape as RefShape
from repro.core.accelerator import _kernel_plan as ref_kernel_plan
from repro.graph import generators as ref_generators
from repro_torch import GraphDelta, GraphShape, StreamingSession, Target
from repro_torch import telemetry
from repro_torch.algorithms import sources
from repro_torch.core import CompileOptions, DistEngine
from repro_torch.core.dist_engine import make_push_step, partition_graph
from repro_torch.launch import serve as serve_cli

DEVICES = [1, 2, 4, 8]
FLOAT_SUMS = {"PAGERANK", "PPR", "CGAW"}
ALGORITHMS = {
    "BFS_ECP": {"root": 3},
    "BFS_HYBRID": {"root": 3},
    "PAGERANK": {"iters": 5},
    "SSSP": {"root": 3},
    "PPR": {"source": 3, "max_iters": 8},
    "CGAW": {},
    "WCC": {},
    "KCORE": {"k": 3},
}
TIMEOUT = 120


def _carry(g):
    return repro_torch.graph_from_arrays(
        g.n_vertices, g.src, g.dst, g.weights,
        n_vertices_logical=g.n_vertices_logical, n_edges_logical=g.n_edges_logical)


@pytest.fixture(scope="module")
def graphs():
    """The reference test's graph: power_law(300, 2500, seed=5, weighted)."""
    g = ref_generators.power_law(300, 2500, seed=5, weighted=True)
    return g, _carry(g)


@pytest.fixture(scope="module")
def padded():
    """A graph with padding (logical counts below the physical ones)."""
    g = ref_generators.uniform_random(161, 900, weighted=True, seed=4)
    shape = RefShape.bucket_for(g.n_vertices, g.n_edges, weighted=True)
    g = g.pad_to(shape.n_vertices, shape.n_edges)
    return g, _carry(g)


def _dist(target=None, n=4):
    return dataclasses.replace(target or Target(), kind="distributed", n_devices=n)


def _ref_mesh1():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))


def _assert_parity(name, want, got, ctx=""):
    assert set(got.properties) == set(want.properties), ctx
    for prop, a in want.properties.items():
        a, b = np.asarray(a), np.asarray(got.properties[prop])
        assert b.dtype == a.dtype and b.shape == a.shape, (ctx, prop)
        if name in FLOAT_SUMS and a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=f"{ctx} {prop}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{ctx} {prop}")
    assert got.host_env == want.host_env, ctx
    assert got.stats.kernel_launches == want.stats.kernel_launches, ctx


def _assert_identical(a, b, ctx=""):
    assert set(a.properties) == set(b.properties)
    for prop, x in a.properties.items():
        y = b.properties[prop]
        assert x.dtype == y.dtype and np.array_equal(x.view(np.uint8), y.view(np.uint8)), \
            f"{ctx} {prop}"
    assert a.host_env == b.host_env, ctx


# ---------------------------------------------------------------------------
# partition and push step
# ---------------------------------------------------------------------------


class _StandInMesh:
    def __init__(self, d):
        self.shape = {"data": d}


@pytest.mark.parametrize("d", DEVICES)
@pytest.mark.parametrize("which", ["power_law", "padded"])
def test_partition_holds_the_references_buckets(graphs, padded, which, d):
    ref_g, g = graphs if which == "power_law" else padded
    want = ref_dist.partition_graph(ref_g, _StandInMesh(d))
    got = partition_graph(g, ["cpu"] * d)
    assert (got.n_devices, got.n_vertices_padded, got.slice_len) == \
        (want.n_devices, want.n_vertices_padded, want.slice_len)
    assert got.emax == want.src_local.shape[2]
    assert got.padded_slots == want.src_local.size
    assert sum(got.shard_edges) == g.n_edges == sum(got.recv_len)
    for i in range(d):
        for j in range(d):
            n = int(want.valid[i, j].sum())
            assert want.valid[i, j, :n].all()
            s, t, w = got.pair(i, j)
            np.testing.assert_array_equal(s, want.src_local[i, j, :n])
            np.testing.assert_array_equal(t, want.dst_local[i, j, :n])
            np.testing.assert_array_equal(w, want.weight[i, j, :n])
    # each destination owner's routing sorts what it receives, stably
    for j in range(d):
        recv = np.concatenate([got.pair(i, j)[1] for i in range(d)])
        perm = got.recv_perm[j].numpy()
        np.testing.assert_array_equal(perm, np.argsort(recv, kind="stable"))
        np.testing.assert_array_equal(
            got.recv_offsets[j].numpy(),
            np.searchsorted(recv[perm], np.arange(got.slice_len + 1)))


@pytest.mark.parametrize("d", DEVICES)
def test_push_step_matches_the_numpy_oracle(graphs, d):
    ref_g, g = graphs
    dg = partition_graph(g, ["cpu"] * d)
    deg = np.maximum(ref_g.out_degree, 1).astype(np.float32)
    rank = np.random.default_rng(0).random(g.n_vertices).astype(np.float32)
    prop = np.zeros(dg.n_vertices_padded, np.float32)
    prop[:g.n_vertices] = rank / deg
    out = make_push_step(dg, lambda sv, w: sv, "+")(torch.from_numpy(prop)).numpy()
    want = np.zeros_like(prop)
    np.add.at(want, ref_g.dst, rank[ref_g.src] / deg[ref_g.src])
    np.testing.assert_allclose(out[:g.n_vertices], want[:g.n_vertices], rtol=1e-5, atol=1e-6)
    sp = np.full(dg.n_vertices_padded, np.inf, np.float32)
    sp[:g.n_vertices] = np.random.default_rng(1).integers(0, 50, g.n_vertices)
    out2 = make_push_step(dg, lambda sv, w: sv + w, "min")(torch.from_numpy(sp)).numpy()
    want2 = np.full_like(sp, np.inf)
    np.minimum.at(want2, ref_g.dst, sp[ref_g.src] + ref_g.weights)
    np.testing.assert_array_equal(out2[:g.n_vertices], want2[:g.n_vertices])


# ---------------------------------------------------------------------------
# all eight programs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(graphs):
    """Cached runs: ("port-local" | "ref-local" | "ref-dist", name, passes, base)."""
    ref_g, g = graphs
    cache = {}

    def get(kind, name, passes, base):
        key = (kind, name, passes, base)
        if key not in cache:
            params = ALGORITHMS[name]
            if kind == "port-local":
                prog = repro_torch.compile(getattr(sources, name), CompileOptions(passes=passes))
                target = Target() if base == "default" else Target.baseline()
                cache[key] = prog.bind(g, device="cpu", target=target).run(**params)
            else:
                opts = repro.CompileOptions(passes=passes)
                prog = repro.compile(getattr(ref_sources, name), opts)
                target = (repro.Target() if base == "default" else repro.Target.baseline())
                if kind == "ref-local":
                    cache[key] = prog.bind(ref_g, target=target).run(**params)
                else:
                    target = dataclasses.replace(target, kind="distributed")
                    cache[key] = prog.bind(ref_g, backend="distributed", mesh=_ref_mesh1(),
                                           target=target).run(**params)
        return cache[key]

    return get


@pytest.mark.parametrize("base", ["default", "baseline"])
@pytest.mark.parametrize("d", DEVICES)
@pytest.mark.parametrize("passes", ["default", "none"])
@pytest.mark.parametrize("name", list(ALGORITHMS))
def test_programs_match_local_and_reference(graphs, runs, name, passes, d, base):
    _, g = graphs
    prog = repro_torch.compile(getattr(sources, name), CompileOptions(passes=passes))
    target = _dist(Target() if base == "default" else Target.baseline(), d)
    got = prog.bind(g, device="cpu", target=target).run(**ALGORITHMS[name])
    ctx = f"{name}/{passes}/D={d}/{base}"
    _assert_parity(name, runs("port-local", name, passes, base), got, ctx + " vs port local")
    _assert_parity(name, runs("ref-local", name, passes, base), got, ctx + " vs ref local")
    ref_dist_run = runs("ref-dist", name, passes, base)
    _assert_parity(name, ref_dist_run, got, ctx + " vs ref distributed")
    assert got.stats.dist_supersteps == ref_dist_run.stats.dist_supersteps, ctx
    assert (got.stats.full_launches, got.stats.compacted_launches) == \
        (ref_dist_run.stats.full_launches, ref_dist_run.stats.compacted_launches), ctx
    if name in ("PAGERANK", "SSSP"):
        # every superstep's shuffle_reduce folds in a fixed order: same bits again
        again = prog.bind(g, device="cpu", target=target).run(**ALGORITHMS[name])
        _assert_identical(got, again, ctx)


def test_min_results_are_the_single_device_bits(padded):
    """Integer and min/max results do not depend on D, on a padded graph
    (the padded tail of ``Vpad`` never reaches a result, and an owner that
    receives no edge still reduces, into the identity)."""
    _, g = padded
    for name, params in (("SSSP", {"root": 2}), ("BFS_ECP", {"root": 5})):
        prog = repro_torch.compile(getattr(sources, name))
        want = prog.bind(g, device="cpu").run(**params)
        for d in (3, 8):
            sess = prog.bind(g, device="cpu", target=_dist(n=d))
            got = sess.run(**params)
            _assert_identical(want, got, f"{name} D={d}")
            assert got.stats.dist_supersteps > 0
            if d == 8:  # the padded tail: owners that receive no edge reduce nothing
                assert 0 in sess.engine._dist_graph.recv_len


# ---------------------------------------------------------------------------
# target, engine
# ---------------------------------------------------------------------------


def test_target_distributed_fields_mesh_and_serialization():
    t = Target(kind="distributed", n_devices=4)
    assert t.describe().startswith("distributed x4(data) [")
    assert t.describe() == repro.Target(kind="distributed", n_devices=4).describe()
    assert Target(kind="distributed").describe().startswith("distributed xall(data) [")
    assert t.mesh("cpu") == ["cpu"] * 4
    assert Target(kind="distributed").mesh("cpu") == ["cpu"]  # 0 = every visible CPU device
    with pytest.raises(ValueError):
        Target().mesh("cpu")
    with pytest.raises(ValueError):
        Target(kind="distributed", n_devices=-1)
    with pytest.raises(ValueError):
        Target(kind="mesh")
    assert Target.from_dict(t.to_dict()) == t
    # a manifest written before the distributed fields existed still loads
    old = {k: v for k, v in Target().to_dict().items() if k not in ("n_devices", "axis")}
    assert Target.from_dict(old) == Target()


def test_session_binds_the_distributed_engine(graphs):
    _, g = graphs
    prog = repro_torch.compile(sources.PAGERANK)
    s = prog.bind(g, device="cpu", target=_dist(n=3))
    assert isinstance(s.engine, DistEngine) and s.engine.mesh == ["cpu"] * 3
    assert type(prog.bind(g, device="cpu").engine).__name__ == "Engine"
    r = s.run(iters=4)
    dg = s.engine._dist_graph
    assert dg is not None and dg.n_devices == 3 and sum(dg.shard_edges) == g.n_edges
    assert r.stats.dist_supersteps == 4


def test_refresh_graph_partitions_again(padded):
    _, g = padded
    g = repro_torch.graph_from_arrays(g.n_vertices, g.src.copy(), g.dst.copy(),
                                      g.weights.copy(), n_vertices_logical=g.n_vertices_logical,
                                      n_edges_logical=g.n_edges_logical)
    prog = repro_torch.compile(sources.SSSP)
    s = prog.bind(g, device="cpu", target=_dist(n=4))
    s.run(root=2)
    first = s.engine._dist_graph
    g.apply_updates(GraphDelta(added_edges=np.array([[2, 7], [7, 40]], np.int32),
                               added_weights=np.array([1.0, 1.0], np.float32)))
    s.refresh_graph(g)
    assert s.engine._dist_graph is None and not s.engine._dist_lowered
    got = s.run(root=2)
    assert s.engine._dist_graph is not first
    _assert_identical(prog.bind(g, device="cpu").run(root=2), got, "refreshed")


# ---------------------------------------------------------------------------
# batched runs and fused pipelines
# ---------------------------------------------------------------------------


BATCH_PARAMS = {
    "BFS_ECP": lambda rng, k: [{"root": int(r)} for r in rng.integers(0, 300, k)],
    "BFS_HYBRID": lambda rng, k: [{"root": int(r)} for r in rng.integers(0, 300, k)],
    "PAGERANK": lambda rng, k: [{"iters": int(i)} for i in rng.integers(2, 8, k)],
    "SSSP": lambda rng, k: [{"root": int(r)} for r in rng.integers(0, 300, k)],
    "PPR": lambda rng, k: [{"source": int(s), "max_iters": 12} for s in rng.integers(0, 300, k)],
    "CGAW": lambda rng, k: [{} for _ in range(k)],
    "WCC": lambda rng, k: [{} for _ in range(k)],
    "KCORE": lambda rng, k: [{"k": int(v)} for v in rng.integers(2, 5, k)],
}


@pytest.mark.parametrize("name", list(ALGORITHMS))
def test_batched_equals_sequential_distributed_runs(graphs, name):
    ref_g, g = graphs
    prog = repro_torch.compile(getattr(sources, name))
    sets = BATCH_PARAMS[name](np.random.default_rng(7), 8)
    target = _dist(n=4)
    sess = prog.bind(g, device="cpu", target=target)
    seq = [sess.run(**p) for p in sets]
    bat = prog.bind_batch(g, device="cpu", target=target).run_many(sets)
    for i, (a, b) in enumerate(zip(seq, bat)):
        _assert_identical(a, b, f"{name}[{i}]")
    ref_bat = repro.compile(getattr(ref_sources, name)).bind_batch(
        ref_g, backend="distributed", mesh=_ref_mesh1()).run_many(sets)
    for i, (want, got) in enumerate(zip(ref_bat, bat)):
        _assert_parity(name, want, got, f"{name}[{i}] vs ref batched")
    assert bat[0].stats.dist_supersteps == ref_bat[0].stats.dist_supersteps
    assert bat[0].stats.batch_size == 8


def test_distributed_batch_still_supersteps(graphs):
    """Batched distributed PageRank keeps running supersteps: one shuffle
    round per iteration for the whole batch, as the reference counts it."""
    _, g = graphs
    prog = repro_torch.compile(sources.PAGERANK)
    bat = prog.bind_batch(g, device="cpu", target=_dist(n=4)).run_many([{"iters": 6}] * 4)
    assert bat[0].stats.dist_supersteps == 6
    assert bat[0].stats.batch_size == 4


def test_distributed_still_supersteps_fused_pipelines(graphs):
    """A fused edge -> vertex pipeline runs its edge stage as a superstep,
    stage by stage, as the reference consumes it."""
    ref_g, g = graphs
    prog = repro_torch.compile(sources.PAGERANK, CompileOptions(passes="default"))
    res = prog.bind(g, device="cpu", target=_dist(n=4)).run(iters=6)
    assert res.stats.dist_supersteps == 6
    assert res.stats.fused_launches == 6
    want = repro.compile(ref_sources.PAGERANK, repro.CompileOptions.full()).bind(
        ref_g, backend="distributed", mesh=_ref_mesh1()).run(iters=6)
    _assert_parity("PAGERANK", want, res)
    assert (res.stats.full_launches, res.stats.edges_traversed) == \
        (want.stats.full_launches, want.stats.edges_traversed)


# ---------------------------------------------------------------------------
# accelerator artifacts
# ---------------------------------------------------------------------------


def test_distributed_lowering_is_lazy_but_reported(graphs):
    ref_g, g = graphs
    prog = repro_torch.compile(sources.PAGERANK)
    target = _dist(n=4)
    acc = prog.lower(target, GraphShape.of(g), device="cpu")
    assert acc.library is None
    rep = acc.report()
    assert all(k.mode == "lazy" for k in rep.kernels)
    ref_prog = repro.compile(ref_sources.PAGERANK)
    ref_target = repro.Target(kind="distributed", n_devices=4)
    want = ref_prog.lower(ref_target, RefShape.of(ref_g)).report()
    assert [(k.name, k.kind, k.stages, k.direction, k.mode) for k in rep.kernels] == \
        [(k.name, k.kind, k.stages, k.direction, k.mode) for k in want.kernels]
    for k, kern in zip(rep.kernels, ref_prog.module.kernels.values()):
        static = ref_kernel_plan(ref_prog.module, kern, None, "lazy", 0.0, RefShape.of(ref_g))
        assert k.flops == static.flops, k.name
    assert rep.state_bytes == want.state_bytes
    assert rep.determinism == want.determinism and rep.pass_report == want.pass_report
    assert rep.describe().splitlines()[0].startswith("accelerator [distributed x4(data) ")
    assert want.describe().splitlines()[0].startswith("accelerator [distributed x4(data) ")
    got = acc.bind(g).run(iters=4)
    _assert_identical(prog.bind(g, device="cpu", target=target).run(iters=4), got)
    assert got.stats.dist_supersteps == 4 and isinstance(acc.bind(g).engine, DistEngine)


@pytest.mark.parametrize("name", list(ALGORITHMS))
def test_distributed_save_load_roundtrip(graphs, tmp_path, name):
    _, g = graphs
    prog = repro_torch.compile(getattr(sources, name))
    target = _dist(n=2)
    acc = prog.lower(target, GraphShape.of(g), device="cpu")
    path = acc.save(str(tmp_path / name))
    with open(f"{path}/manifest.json") as f:
        assert json.load(f)["target"] == target.to_dict()
    loaded = repro_torch.load_accelerator(path, device="cpu")
    assert loaded.target == target and loaded.fingerprint == acc.fingerprint
    assert loaded.library is None and {k.mode for k in loaded.report().kernels} == {"lazy"}
    params = ALGORITHMS[name]
    want = prog.bind(g, device="cpu", target=target).run(**params)
    _assert_identical(want, loaded.bind(g).run(**params), name)
    _assert_identical(want, loaded.bind_batch(g).run_many([params])[0], name + " batched")
    with loaded.pool(g, size=2) as pool:
        _assert_identical(want, pool.submit(**params).result(timeout=TIMEOUT), name + " pool")


# ---------------------------------------------------------------------------
# streaming, serving, the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,params,weighted", [
    ("BFS_ECP", {"root": 2}, False), ("SSSP", {"root": 2}, True), ("WCC", {}, False),
])
def test_streaming_repair_equals_a_full_distributed_run(name, params, weighted):
    """The logic of the reference's distributed streaming case, held to the
    port's full distributed runs and to its local ones."""
    rng = np.random.default_rng(5)
    g = ref_generators.uniform_random(160, 900, weighted=weighted, seed=4)
    shape = GraphShape.bucket_for(g.n_vertices, g.n_edges, weighted=weighted)
    program = repro_torch.compile(getattr(sources, name))
    ss = StreamingSession(program, _carry(g).pad_to(shape.n_vertices, shape.n_edges),
                          backend="distributed", device="cpu")
    try:
        assert ss.backend == "distributed" and ss.target.kind == "distributed"
        assert isinstance(ss.session.engine, DistEngine)
        ss.run(**params)
        for _ in range(2):
            lv = ss.graph.n_vertices_logical
            e = rng.integers(0, lv, size=(12, 2)).astype(np.int32)
            w = rng.integers(1, 64, size=12).astype(np.float32) if weighted else None
            ss.update(GraphDelta(added_edges=e, added_weights=w))
            got = ss.run(**params)
            full = program.bind(ss.graph, device="cpu", target=ss.target).run(**params)
            local = program.bind(ss.graph, device="cpu").run(**params)
            for want in (full, local):
                for p in want.properties:
                    np.testing.assert_array_equal(got.properties[p], want.properties[p],
                                                  err_msg=p)
                assert got.host_env == want.host_env
            assert (full.stats.dist_supersteps > 0) == (name != "WCC")  # WCC stays local
        assert ss.incremental_runs == 2
    finally:
        ss.close()


SERVED = {"bfs": "BFS_ECP", "sssp": "SSSP", "pagerank": "PAGERANK"}


#: a batch's fill wait long enough that each group's requests form one
#: batch in both services, whatever the host's load
FILL_WAIT_S = 60.0


def test_distributed_service_answers_as_the_local_one():
    """Each program's requests, served as one batch by a distributed and a
    local service, give the same answers and stats. A result's stats are
    those of the batch that answered it (a batch runs until its last lane
    converges; BFS_ECP batches take MS-BFS), so both services get
    ``max_batch`` equal to the group's size and a long fill wait: a batch
    closes when the whole group has arrived, not at a timer that a loaded
    host may pass between two submissions."""
    g = ref_generators.uniform_random(240, 1500, weighted=True, seed=11)
    g = repro_torch.graph_from_arrays(g.n_vertices, g.src, g.dst, g.weights)
    cases = {"bfs": [{"root": r} for r in (0, 5, 9)], "sssp": [{"root": 1}, {"root": 4}],
             "pagerank": [{"iters": 4}, {"iters": 7}]}
    for name, sets in cases.items():
        with repro_torch.serve(False, backend="distributed", device="cpu", workers=2,
                               max_batch=len(sets), max_wait_s=FILL_WAIT_S) as dist, \
                repro_torch.serve(False, device="cpu", workers=2, max_batch=len(sets),
                                  max_wait_s=FILL_WAIT_S) as local:
            futs = [(dist.submit(name, g, **p), local.submit(name, g, **p)) for p in sets]
            for f_d, f_l in futs:
                got, want = f_d.result(timeout=TIMEOUT), f_l.result(timeout=TIMEOUT)
                _assert_parity(SERVED[name], want, got, name)
            keys = list(dist.registry._residents)
            assert keys and all(k[1].kind == "distributed" for k in keys)
            assert dist.stats()["batches"]["batches"] == local.stats()["batches"]["batches"] == 1


def test_cli_backend_distributed(tmp_path, capsys):
    assert serve_cli.main(["--graph", "sssp", "--device", "cpu", "--queries", "4",
                           "--vertices", "200", "--edges", "1000", "--backend", "distributed",
                           "--artifact-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "distributed backend" in out and "answered 4 queries" in out
    assert serve_cli.main(["--graph", "bfs", "--device", "cpu", "--queries", "6",
                           "--vertices", "200", "--edges", "1000", "--backend", "distributed",
                           "--updates", "2", "--pool", "1"]) == 0
    assert "distributed backend" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the span tree
# ---------------------------------------------------------------------------


SPAN_KEYS = ("kernel", "kind", "direction", "mode", "edges", "devices", "shuffle_elements")


def _spans(tr):
    return [(s.name,) + tuple(s.attrs.get(k) for k in SPAN_KEYS) for s in tr.spans()
            if s.name.startswith("launch:") or s.name == "superstep"]


def test_span_tree_equals_the_reference_one_device_tree():
    from repro import telemetry as ref_telemetry

    g = ref_generators.power_law(300, 2400, seed=2)
    trees = {}
    for key, pkg, tel, src, graph, kwargs in (
            ("reference", repro, ref_telemetry, ref_sources.BFS_ECP, g,
             {"backend": "distributed", "mesh": _ref_mesh1()}),
            ("port", repro_torch, telemetry, sources.BFS_ECP, _carry(g),
             {"device": "cpu", "target": _dist(n=1)})):
        tr = tel.enable()
        try:
            tr.reset()
            result = pkg.compile(src).bind(graph, **kwargs).run(root=3)
            run = [s for s in tr.spans() if s.name == "run"]
            by_id = {s.span_id: s for s in tr.spans()}
            parents = [by_id[s.parent_id].name for s in tr.spans() if s.name == "superstep"]
            trees[key] = (result, _spans(tr), run, parents)
        finally:
            tel.disable()
    (want, want_spans, want_run, want_parents), (got, got_spans, got_run, got_parents) = \
        trees["reference"], trees["port"]
    assert len(got_spans) == len(want_spans) > 0
    for i, (a, b) in enumerate(zip(got_spans, want_spans)):
        assert a == b, f"span {i}: port {a} != reference {b}"
    assert got.stats.dist_supersteps == want.stats.dist_supersteps > 0
    assert sum(s[0] == "superstep" for s in got_spans) == got.stats.dist_supersteps
    assert "dist" in {s[4] for s in got_spans}
    assert got_parents == want_parents and all(p.startswith("launch:") for p in got_parents)
    assert got_run[0].attrs["engine"] == want_run[0].attrs["engine"] == "DistEngine"
    assert got_run[0].attrs["supersteps"] == want_run[0].attrs["supersteps"]
    assert got.trace["spans"]["superstep"]["count"] == got.stats.dist_supersteps
