"""The port's accelerator artifacts against the reference package.

``lower`` -> ``save`` -> ``load_accelerator(device="cpu")`` -> ``bind`` ->
``run`` for every program of ``algorithms/sources.py`` under passes
default/none, on one graph made from a numpy seed
(``power_law(200, 1400, seed=5, weighted=True)``, carried across with
``graph_from_arrays``; the twin of the same bucket is seed 11). The port
runs on the CPU, where its kernel wrappers take their plain versions.

* The loaded run is bit-identical to the port's own
  ``compile(src).bind(g, device="cpu").run(...)``, CGAW included.
* Against the reference's fresh ``repro.compile(src, opts).bind(g).run``
  it meets the parity contract: BFS_ECP, BFS_HYBRID, SSSP, WCC, KCORE
  bit-exact; PAGERANK, PPR, CGAW ``rtol=1e-5, atol=1e-6``; host scalars
  and launch counts equal. (The reference's own CGAW round trip is off, so
  the port is held to its fresh bind, not to its round trip.)
* The saved ``mir.txt`` and the manifest's ``mir_fingerprint`` equal the
  reference's canonical MIR and its hash.
* The report's kernel plan, state bytes and static op estimate equal the
  reference's; errors, fingerprints, the artifact store and the Program
  cache behave as the reference's tests require of it.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.algorithms import sources as ref_sources
from repro.core import accelerator as ref_accelerator
from repro.core import mir as ref_mir
from repro.graph import generators as ref_generators
from repro_torch.algorithms import sources
from repro_torch.core import SessionError, accelerator, mir
from repro_torch.core.accelerator import (
    AcceleratorError, GraphShape, accelerator_fingerprint, load_or_lower, quarantine_artifact,
)
from repro_torch.core.program import (
    clear_program_cache, program_cache_size, set_program_cache_limit,
)

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


def _pair(seed):
    g = ref_generators.power_law(200, 1400, seed=seed, weighted=True)
    return g, repro_torch.graph_from_arrays(g.n_vertices, g.src, g.dst, g.weights,
                                            n_vertices_logical=g.n_vertices_logical,
                                            n_edges_logical=g.n_edges_logical)


@pytest.fixture(scope="module")
def graphs():
    return _pair(5)


@pytest.fixture(scope="module")
def twins():
    """A different graph of the identical (|V|, |E|, weighted) bucket."""
    return _pair(11)


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's fresh bind + run, once per (graph, program, passes)."""
    cache = {}

    def run(g, algo, passes="default"):
        key = (id(g), algo, passes)
        if key not in cache:
            name, params = ALGORITHMS[algo]
            prog = repro.compile(getattr(ref_sources, name),
                                 repro.CompileOptions(passes=passes))
            cache[key] = (prog, prog.bind(g).run(**params))
        return cache[key]

    return run


@pytest.fixture(scope="module")
def ref_reports(graphs):
    """The reference's ``lower(graph=g).report()`` per program (default passes)."""
    cache = {}

    def report(algo):
        if algo not in cache:
            prog = repro.compile(getattr(ref_sources, ALGORITHMS[algo][0]))
            cache[algo] = (prog, prog.lower(graph=graphs[0]).report())
        return cache[algo]

    return report


def _port_program(algo, passes="default"):
    return repro_torch.compile(getattr(sources, ALGORITHMS[algo][0]),
                               repro_torch.CompileOptions(passes=passes))


def _assert_identical(a, b):
    assert set(a.properties) == set(b.properties)
    for name, x in a.properties.items():
        y = b.properties[name]
        assert x.dtype == y.dtype and np.array_equal(x.view(np.uint8), y.view(np.uint8)), name
    assert a.host_env == b.host_env


def _assert_parity(algo, want, got):
    """The ROADMAP's contract between the reference and the port."""
    assert set(got.properties) == set(want.properties)
    for prop, a in want.properties.items():
        b = got.properties[prop]
        assert b.dtype == a.dtype and b.shape == a.shape, prop
        if algo in FLOAT_SUMS and a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=prop)
        else:
            np.testing.assert_array_equal(b, a, err_msg=prop)
    assert got.host_env == want.host_env
    ws, gs = want.stats, got.stats
    assert gs.kernel_launches == ws.kernel_launches
    assert (gs.compacted_launches, gs.full_launches, gs.fused_launches) == \
        (ws.compacted_launches, ws.full_launches, ws.fused_launches)


# ---------------------------------------------------------------------------
# the round-trip matrix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("passes", ["default", "none"])
@pytest.mark.parametrize("algo", sorted(ALGORITHMS))
def test_save_load_roundtrip_matrix(graphs, ref_runs, tmp_path, algo, passes):
    g, tg = graphs
    params = ALGORITHMS[algo][1]
    prog = _port_program(algo, passes)
    acc = prog.lower(graph=tg, device="cpu")
    path = acc.save(str(tmp_path / f"{algo}-{passes}"))
    loaded = repro_torch.load_accelerator(path, device="cpu")
    assert loaded.fingerprint == acc.fingerprint
    assert {k.mode for k in loaded.report().kernels} == {"aot"}  # nothing built on the CPU
    got = loaded.bind(tg).run(**params)
    _assert_identical(prog.bind(tg, device="cpu").run(**params), got)
    ref_prog, want = ref_runs(g, algo, passes)
    _assert_parity(algo, want, got)
    with open(os.path.join(path, "mir.txt")) as f:
        assert f.read() == ref_mir.canonical_serialize(ref_prog.module)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["mir_fingerprint"] == ref_mir.fingerprint(ref_prog.module)
    assert manifest["substrate"] == "torch" and manifest["device"] == "cpu"
    assert set(manifest["libraries"]) == set(accelerator.GRAPH_LIBRARIES)


# ---------------------------------------------------------------------------
# lower -> bind equivalence + shape-bucket rebinding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", sorted(ALGORITHMS))
def test_bucket_rebinding_matches_independent_programs(graphs, twins, ref_runs, algo):
    """Two graphs of one bucket bound to ONE accelerator equal independently
    compiled programs in both packages."""
    params = ALGORITHMS[algo][1]
    acc = _port_program(algo).lower(graph=graphs[1], device="cpu")
    for g, tg in (graphs, twins):
        got = acc.bind(tg).run(**params)
        _assert_identical(_port_program(algo).bind(tg, device="cpu").run(**params), got)
        _assert_parity(algo, ref_runs(g, algo)[1], got)
    assert acc.binds == 2


def test_rebind_first_run_is_compile_free(graphs, twins):
    acc = _port_program("bfs").lower(graph=graphs[1], device="cpu")
    # lowering marks each kernel's full stream warm, as the reference's AOT
    # compile does, and nothing else
    assert acc.library.warm_keys == {("full", name) for name in acc.library.module.kernels}
    first = acc.bind(graphs[1]).run(root=3)
    # the first run times its first touch of each frontier pad as compile time
    assert first.stats.compacted_launches > 0
    assert first.stats.compile_time_s > 0
    assert first.stats.wall_time_s >= first.stats.compile_time_s
    warmed = set(acc.library.warm_keys)
    assert {key[0] for key in warmed} == {"full", "subset", "fbuild"}
    rebind = acc.bind(twins[1]).run(root=3)
    # the rebind reuses every pad the first bind warmed: its keys are shared
    assert acc.library.warm_keys == warmed
    assert rebind.stats.compile_time_s == 0.0
    assert rebind.stats.run_time_s == rebind.stats.wall_time_s > 0


@pytest.mark.parametrize("algo", ["bfs", "sssp", "pagerank", "wcc"])
def test_run_many_bind_batch_and_pool_on_accelerator_sessions(graphs, algo):
    tg = graphs[1]
    name, params = ALGORITHMS[algo]
    key = next(iter(params), None)
    sets = [dict(params, **({key: v} if key else {})) for v in (3, 0, 9, 17)]
    acc = _port_program(algo).lower(graph=tg, device="cpu")
    sess = acc.bind(tg)
    want = [sess.run(**p) for p in sets]
    for p, w in zip(sets, want):
        _assert_identical(_port_program(algo).bind(tg, device="cpu").run(**p), w)
    got_many = sess.run_many(sets)
    got_batch = acc.bind_batch(tg).run_many(sets)
    with acc.pool(tg, size=2) as pool:
        got_pool = pool.run_batch(sets, batched=False)
        got_pool_batched = pool.run_batch(sets)
    for got in (got_many, got_batch, got_pool, got_pool_batched):
        for w, r in zip(want, got):
            _assert_identical(w, r)
    assert got_batch[0].stats.batch_size == len(sets)
    assert acc.binds == 3


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", sorted(ALGORITHMS))
def test_report_matches_reference(graphs, ref_reports, algo):
    ref_prog, want = ref_reports(algo)
    rep = _port_program(algo).lower(graph=graphs[1], device="cpu").report()
    shape = ref_accelerator.GraphShape.of(graphs[0])
    assert rep.shape.to_dict() == want.shape.to_dict()
    assert [(k.name, k.kind, k.stages, k.direction) for k in rep.kernels] == \
        [(k.name, k.kind, k.stages, k.direction) for k in want.kernels]
    assert rep.state_bytes == want.state_bytes
    assert rep.gb_bytes > 0
    assert rep.live_buffer_peak_bytes >= rep.state_bytes + rep.gb_bytes
    assert rep.determinism == want.determinism
    assert rep.pass_report == want.pass_report
    for k, kern in zip(rep.kernels, ref_prog.module.kernels.values()):
        static = ref_accelerator._kernel_plan(ref_prog.module, kern, None, "aot", 0.0, shape)
        assert k.flops > 0 and k.flops == static.flops, k.name
        assert (k.bytes_accessed, k.arg_bytes, k.out_bytes, k.temp_bytes) == (None,) * 4
    assert rep.total_flops_per_launch_set > 0
    ours, theirs = rep.describe().splitlines(), want.describe().splitlines()
    assert ours[0].startswith("accelerator [local ") and "live peak" in ours[1]
    for prefix in ("  determinism:", "  pass "):
        assert [x for x in ours if x.startswith(prefix)] == \
            [x for x in theirs if x.startswith(prefix)]
    # each kernel's line up to its direction, as the reference prints it
    assert [x.split(" ~")[0].replace(" aot ", " ") for x in ours if x.startswith("  kernel ")] \
        == [x.split(" ~")[0].replace(" aot ", " ") for x in theirs if x.startswith("  kernel ")]


# ---------------------------------------------------------------------------
# errors, fingerprints, the artifact store
# ---------------------------------------------------------------------------


def test_graph_shape_of_bucketed_and_bucket_for_match_reference(graphs):
    g, tg = graphs
    s = GraphShape.of(tg)
    assert s == GraphShape(200, 1400, True)
    b = s.bucketed(v_round=256, e_round=1024)
    assert b == GraphShape(256, 2048, True)
    padded = tg.pad_to(b.n_vertices, b.n_edges)
    assert b.accepts(padded) and not b.accepts(tg)
    for n_v, n_e in [(1, 1), (200, 1400), (5000, 70000), (524288, 16777216)]:
        assert GraphShape.bucket_for(n_v, n_e).to_dict() == \
            ref_accelerator.GraphShape.bucket_for(n_v, n_e).to_dict()


def test_lower_requires_shape():
    with pytest.raises(repro_torch.ProgramError, match="shape bucket"):
        _port_program("bfs").lower(device="cpu")


def test_lower_and_load_raise_without_a_gpu(graphs, tmp_path, monkeypatch):
    acc = _port_program("bfs").lower(graph=graphs[1], device="cpu")
    path = acc.save(str(tmp_path / "bfs"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SessionError, match="device='cpu'"):
        _port_program("bfs").lower(graph=graphs[1])
    with pytest.raises(SessionError, match="device='cpu'"):
        repro_torch.load_accelerator(path)


def test_weighted_program_needs_weighted_bucket():
    with pytest.raises(AcceleratorError, match="weighted"):
        _port_program("sssp").lower(shape=GraphShape(100, 500, weighted=False), device="cpu")


def test_bind_shape_mismatch_raises(graphs):
    acc = _port_program("bfs").lower(shape=GraphShape(100, 500), device="cpu")
    with pytest.raises(AcceleratorError, match="pad the"):
        acc.bind(graphs[1])


def test_lower_bucket_true_binds_the_padded_graph(graphs):
    tg = graphs[1]
    acc = _port_program("pagerank").lower(graph=tg, bucket=True, device="cpu")
    assert acc.shape == GraphShape.bucket_for(200, 1400, weighted=True)
    got = acc.bind(tg.pad_to(acc.shape.n_vertices, acc.shape.n_edges)).run(iters=5)
    want = _port_program("pagerank").bind(tg, device="cpu").run(iters=5)
    np.testing.assert_allclose(got.properties["rank"][:200], want.properties["rank"],
                               rtol=1e-5, atol=1e-6)


def test_target_dict_roundtrip():
    t = repro_torch.Target(burst=False, n_partitions=3)
    assert repro_torch.Target.from_dict(t.to_dict()) == t
    with pytest.raises(ValueError, match="unknown Target fields"):
        repro_torch.Target.from_dict({"kind": "local", "pallas": True})


def test_load_rejects_stale_artifact_and_wrong_format(graphs, tmp_path):
    acc = _port_program("bfs").lower(graph=graphs[1], device="cpu")
    path = acc.save(str(tmp_path / "bfs"))
    with open(os.path.join(path, "program.gt")) as f:
        drifted = f.read().replace("func main()", "const drift: int = 1;\nfunc main()", 1)
    with open(os.path.join(path, "program.gt"), "w") as f:
        f.write(drifted)
    with pytest.raises(AcceleratorError, match="stale"):
        repro_torch.load_accelerator(path, device="cpu")
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["format"] = 999
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(AcceleratorError, match="format"):
        repro_torch.load_accelerator(path, device="cpu")


def test_load_rejects_a_reference_artifact(graphs, ref_reports, tmp_path):
    ref_prog, _ = ref_reports("bfs")
    path = ref_prog.lower(graph=graphs[0]).save(str(tmp_path / "jax-bfs"))
    with pytest.raises(AcceleratorError, match="format"):
        repro_torch.load_accelerator(path, device="cpu")


def test_accelerator_fingerprint_is_content_keyed(graphs):
    prog = _port_program("bfs")
    s = GraphShape.of(graphs[1])
    f1 = accelerator_fingerprint(prog.fingerprint, repro_torch.Target(), s)
    assert f1 == accelerator_fingerprint(prog.fingerprint, repro_torch.Target(), s)
    assert f1 != accelerator_fingerprint(prog.fingerprint, repro_torch.Target.baseline(), s)
    assert f1 != accelerator_fingerprint(
        prog.fingerprint, repro_torch.Target(), GraphShape(s.n_vertices, s.n_edges + 1, True))
    assert f1 != accelerator_fingerprint(_port_program("bfs", "none").fingerprint,
                                         repro_torch.Target(), s)


def test_load_or_lower_miss_hit_and_corrupt(graphs, tmp_path):
    prog, shape, target = _port_program("wcc"), GraphShape.of(graphs[1]), repro_torch.Target()
    store = str(tmp_path / "store")
    acc, loaded, secs = load_or_lower(prog, target, shape, store, device="cpu")
    assert not loaded and secs >= 0
    acc2, loaded, _ = load_or_lower(prog, target, shape, store, device="cpu")
    assert loaded and acc2.fingerprint == acc.fingerprint
    _assert_identical(acc.bind(graphs[1]).run(), acc2.bind(graphs[1]).run())
    path = os.path.join(store, acc.fingerprint[:24])
    with open(os.path.join(path, "manifest.json"), "w") as f:
        f.write("{ not json")
    acc3, loaded, _ = load_or_lower(prog, target, shape, store, device="cpu")
    assert not loaded and acc3.fingerprint == acc.fingerprint
    # the lowering healed the store
    assert load_or_lower(prog, target, shape, store, device="cpu")[1]


def test_quarantine_artifact_moves_the_directory_aside(graphs, tmp_path):
    path = _port_program("bfs").lower(graph=graphs[1], device="cpu").save(
        str(tmp_path / "bad"))
    moved = quarantine_artifact(path)
    assert moved == path + ".quarantined"
    assert not os.path.exists(path) and os.path.isfile(os.path.join(moved, "manifest.json"))
    os.makedirs(path)
    assert quarantine_artifact(path) == path + ".quarantined.1"


def test_profile_and_program_fingerprint_persist(graphs, tmp_path):
    acc = _port_program("sssp").lower(graph=graphs[1], device="cpu")
    acc.record_profile({"spans": {"launch:relax": {"count": 2, "total_s": 0.5,
                                                   "max_s": 0.3}}})
    loaded = repro_torch.load_accelerator(acc.save(str(tmp_path / "s")), device="cpu")
    assert loaded.program is acc.program  # the Program cache served the source
    assert loaded.report().profile == {"runs": 1, "spans": {
        "launch:relax": {"count": 2, "total_s": 0.5, "max_s": 0.3}}}


# ---------------------------------------------------------------------------
# the Program cache (the reference's bodies, pointed at the port)
# ---------------------------------------------------------------------------


def test_program_cache_is_lru():
    clear_program_cache()
    set_program_cache_limit(2)
    try:
        srcs = [sources.BFS_ECP, sources.PAGERANK, sources.WCC]
        progs = [repro_torch.compile(s) for s in srcs]
        info = repro_torch.program_cache_info()
        assert info.maxsize == 2 and info.currsize == 2
        assert info.evictions >= 1
        # evicted entries recompile to an equal (but distinct) Program
        again = repro_torch.compile(srcs[0])
        assert again is not progs[0]
        assert again.fingerprint == progs[0].fingerprint
        # cached entries hit
        hits_before = repro_torch.program_cache_info().hits
        assert repro_torch.compile(srcs[0]) is again
        assert repro_torch.program_cache_info().hits > hits_before
    finally:
        set_program_cache_limit(64)
        clear_program_cache()


def test_program_cache_info_counts():
    clear_program_cache()
    repro_torch.compile(sources.BFS_ECP)
    misses = repro_torch.program_cache_info().misses
    assert misses >= 1
    repro_torch.compile(sources.BFS_ECP)
    info = repro_torch.program_cache_info()
    assert info.hits >= 1 and info.currsize == 1 and program_cache_size() == 1


def test_program_fingerprint_keys_mir_and_options():
    a = repro_torch.compile(sources.BFS_ECP)
    # comments and whitespace do not change the MIR
    b = repro_torch.compile("% a comment\n" + sources.BFS_ECP + "\n\n")
    assert b is a and a.fingerprint == b.fingerprint
    c = repro_torch.compile(sources.BFS_ECP, repro_torch.CompileOptions(passes="none"))
    assert c.fingerprint != a.fingerprint
    assert mir.fingerprint(a.module) == ref_mir.fingerprint(
        repro.compile(ref_sources.BFS_ECP).module)
