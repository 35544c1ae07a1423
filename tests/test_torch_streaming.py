"""The port's streaming graph updates against the reference package.

``GraphDelta`` / ``apply_updates`` / ``compact``, ``GraphShape.bucket_for``,
``analyze_incremental``, ``refresh_graph`` on every serving surface and
``StreamingSession`` (update, version-pinned cache, host repair, full runs,
re-bucketing, the pool's concurrent queries), each case the port's twin of
one in ``tests/test_streaming.py`` (the subprocess distributed case has
its twin in ``tests/test_torch_distributed.py``). The port runs on the CPU, where its kernel
wrappers take their plain versions; graphs are made from numpy seeds by the
reference's generators and carried across with ``graph_from_arrays``.

Parity contract: BFS_ECP, SSSP, WCC bit-exact; PAGERANK and CGAW
``rtol=1e-5, atol=1e-6``; host scalars, versions, the session counters
(``incremental_runs``, ``full_runs``, ``cache_hits``, ``rebuckets``) and
launch counts equal.
"""
import threading

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.algorithms import sources as ref_sources
from repro.core.accelerator import GraphShape as RefShape
from repro.core.passes import analyze_incremental as ref_analyze
from repro.graph import generators as ref_generators
from repro.graph.storage import GraphData as RefGraph
from repro.graph.storage import GraphDelta as RefDelta
from repro.graph.storage import GraphUpdateError as RefUpdateError
from repro.streaming import StreamingSession as RefStreaming
from repro_torch import GraphDelta, GraphShape, GraphUpdateError, StreamingSession
from repro_torch import telemetry as tel
from repro_torch.algorithms import sources
from repro_torch.core.passes import analyze_incremental
from repro_torch.graph.storage import GraphData

from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings
from _hypothesis_compat import strategies as st

FLOAT_SUMS = {"PAGERANK", "PPR", "CGAW"}
STREAM_CASES = {
    "bfs": ("BFS_ECP", {"root": 3}, False),
    "sssp": ("SSSP", {"root": 3}, True),
    "wcc": ("WCC", {}, False),
    "pagerank": ("PAGERANK", {"iters": 6}, False),
}


def _carry(g):
    """The port's copy of a reference graph (same edges, same order, same
    logical counts)."""
    return repro_torch.graph_from_arrays(
        g.n_vertices, g.src, g.dst, g.weights,
        n_vertices_logical=g.n_vertices_logical, n_edges_logical=g.n_edges_logical)


def _bucketed(n_vertices=300, n_edges=1800, *, weighted=False, seed=1):
    """(reference graph, port graph): one uniform graph padded to its bucket."""
    g = ref_generators.uniform_random(n_vertices, n_edges, weighted=weighted, seed=seed)
    shape = RefShape.bucket_for(g.n_vertices, g.n_edges, weighted=weighted)
    g = g.pad_to(shape.n_vertices, shape.n_edges)
    return g, _carry(g)


def _deltas(rng, graph, k, *, weighted=False):
    """The same random additions as a (reference, port) delta pair."""
    lv = graph.n_vertices_logical
    edges = rng.integers(0, lv, size=(k, 2)).astype(np.int32)
    w = rng.integers(1, 64, size=k).astype(np.float32) if weighted else None
    return (RefDelta(added_edges=edges, added_weights=w),
            GraphDelta(added_edges=edges, added_weights=w))


def _programs(name, passes="default"):
    return (repro.compile(getattr(ref_sources, name), repro.CompileOptions(passes=passes)),
            repro_torch.compile(getattr(sources, name),
                                repro_torch.CompileOptions(passes=passes)))


def _assert_identical(a, b):
    """The port against itself: every property bit for bit, host scalars."""
    assert set(a.properties) == set(b.properties)
    for name, x in a.properties.items():
        y = b.properties[name]
        assert x.dtype == y.dtype and np.array_equal(x.view(np.uint8), y.view(np.uint8)), name
    assert a.host_env == b.host_env


def _assert_parity(name, want, got, launches=True):
    """The port against the reference (the ROADMAP's contract)."""
    assert set(got.properties) == set(want.properties)
    for prop, a in want.properties.items():
        a, b = np.asarray(a), np.asarray(got.properties[prop])
        assert b.dtype == a.dtype and b.shape == a.shape, prop
        if name in FLOAT_SUMS and a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=prop)
        else:
            np.testing.assert_array_equal(b, a, err_msg=prop)
    assert got.host_env == want.host_env
    assert got.version == want.version
    if launches:
        ws, gs = want.stats, got.stats
        assert gs.kernel_launches == ws.kernel_launches
        assert (gs.compacted_launches, gs.full_launches) == \
            (ws.compacted_launches, ws.full_launches)


def _counters(ss):
    return (ss.version, ss.updates, ss.incremental_runs, ss.full_runs, ss.cache_hits,
            ss.rebuckets)


def _same_graph(ref, port):
    np.testing.assert_array_equal(port.src, ref.src)
    np.testing.assert_array_equal(port.dst, ref.dst)
    if ref.weights is None:
        assert port.weights is None
    else:
        np.testing.assert_array_equal(port.weights, ref.weights)
    assert (port.n_vertices, port.n_edges, port.n_vertices_logical, port.n_edges_logical,
            port.version) == (ref.n_vertices, ref.n_edges, ref.n_vertices_logical,
                              ref.n_edges_logical, ref.version)


# ---------------------------------------------------------------------------
# GraphDelta + apply_updates (storage layer)
# ---------------------------------------------------------------------------


def test_graph_delta_validation_and_introspection():
    for Delta in (RefDelta, GraphDelta):
        d = Delta(added_edges=[(0, 1), (2, 3)], removed_edges=[(4, 5)])
        assert d.n_added == 2 and d.n_removed == 1
        assert not d.additions_only
        assert sorted(d.endpoints().tolist()) == [0, 1, 2, 3, 4, 5]
        assert Delta(added_edges=[(7, 8)]).additions_only
        with pytest.raises(ValueError):
            Delta(added_edges=np.zeros((2, 3)))
        with pytest.raises(ValueError):
            Delta(added_edges=[(0, 1)], added_weights=[1.0, 2.0])
    a, b = RefDelta(added_edges=[(0, 1)]), GraphDelta(added_edges=[(0, 1)])
    assert a.added_edges.dtype == b.added_edges.dtype
    assert a.removed_edges.shape == b.removed_edges.shape


def test_apply_updates_add_and_remove_in_place():
    ref = RefGraph(4, src=[0, 1, 2], dst=[1, 2, 3]).pad_to(6, 8)
    g = GraphData(4, src=[0, 1, 2], dst=[1, 2, 3]).pad_to(6, 8)
    buffers = (g.src, g.dst)
    _same_graph(ref, g)
    for delta in ({"added_edges": [(3, 0), (0, 2)]}, {"removed_edges": [(1, 2)]}):
        ref.apply_updates(RefDelta(**delta))
        g.apply_updates(GraphDelta(**delta))
        _same_graph(ref, g)
        assert g.src is buffers[0] and g.dst is buffers[1]  # in place
    assert g.n_edges_logical == 4 and g.n_edges == 8  # physical unchanged
    np.testing.assert_array_equal(g.out_degree, ref.out_degree)
    np.testing.assert_array_equal(g._free_slot_mask(), ref._free_slot_mask())


def test_apply_updates_weighted_sequence_matches_reference():
    ref, g = _bucketed(200, 1100, weighted=True, seed=4)
    rng = np.random.default_rng(7)
    for step in range(4):
        rd, pd = _deltas(rng, ref, 25, weighted=True)
        if step == 2:  # a removal of real edges, and one addition without a weight
            real = np.flatnonzero(~ref._free_slot_mask())[5:9]
            rem = np.stack([ref.src[real], ref.dst[real]], axis=1)
            rd = RefDelta(added_edges=[(1, 2)], removed_edges=rem)
            pd = GraphDelta(added_edges=[(1, 2)], removed_edges=rem)
        ref.apply_updates(rd, compact=step == 3)
        g.apply_updates(pd, compact=step == 3)
        _same_graph(ref, g)
        for attr in ("csr", "csc"):
            for x, y in zip(getattr(ref, attr), getattr(g, attr)):
                np.testing.assert_array_equal(y, x)


def test_apply_updates_errors():
    for Graph, Delta, Error in ((RefGraph, RefDelta, RefUpdateError),
                                (GraphData, GraphDelta, GraphUpdateError)):
        g = Graph(4, src=[0, 1, 2], dst=[1, 2, 3]).pad_to(6, 8)
        with pytest.raises(Error, match="vertex"):
            g.apply_updates(Delta(added_edges=[(0, 99)]))
        with pytest.raises(Error, match="present"):
            g.apply_updates(Delta(removed_edges=[(3, 3)]))
        with pytest.raises(Error, match="bucket_for"):
            g.apply_updates(Delta(added_edges=[(0, 1)] * 50))
        assert g.n_edges_logical == 3  # failed updates must not partially mutate
        flat = Graph(4, src=[0, 1, 2], dst=[1, 2, 3])
        with pytest.raises(Error):
            flat.apply_updates(Delta(added_edges=[(0, 3)]))


def test_apply_updates_duplicate_edges_and_compact():
    ref = RefGraph(4, src=[0, 1, 1, 2], dst=[1, 2, 2, 3]).pad_to(6, 12)
    g = GraphData(4, src=[0, 1, 1, 2], dst=[1, 2, 2, 3]).pad_to(6, 12)
    ref.apply_updates(RefDelta(removed_edges=[(1, 2)]))
    g.apply_updates(GraphDelta(removed_edges=[(1, 2)]))
    real = ~g._free_slot_mask()
    assert list(zip(g.src[real], g.dst[real])).count((1, 2)) == 1
    ref.apply_updates(RefDelta(added_edges=[(3, 0)]), compact=True)
    g.apply_updates(GraphDelta(added_edges=[(3, 0)]), compact=True)
    _same_graph(ref, g)
    real = ~g._free_slot_mask()
    assert real[: g.n_edges_logical].all() and not real[g.n_edges_logical:].any()


def test_logical_counts_propagate_through_transforms():
    ref = ref_generators.uniform_random(50, 300, weighted=True, seed=0)
    p = _carry(ref).pad_to(64, 512)
    assert (p.n_vertices_logical, p.n_edges_logical) == (50, 300)
    assert p.relabel_by_degree()[0].n_vertices_logical == 50
    assert p.with_unit_weights().n_edges_logical == 300
    _same_graph(ref.pad_to(64, 512), p)


# ---------------------------------------------------------------------------
# GraphShape.bucket_for
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_bucket_for_geometric_rounding(weighted):
    s = GraphShape.bucket_for(300, 1800, weighted=weighted)
    assert s.n_vertices >= 300 * 1.12 and s.n_edges >= 1800 * 1.12
    assert s == GraphShape.bucket_for(310, 1850, weighted=weighted)
    big = GraphShape.bucket_for(3000, 18000)
    assert big.n_vertices > s.n_vertices and big.n_edges > s.n_edges
    assert GraphShape.bucket_for(1024, 100).n_vertices > 1024
    for n_v, n_e in ((300, 1800), (310, 1850), (1024, 100), (10, 50), (524288, 16777216),
                     (3000, 18000), (1, 1)):
        ours = GraphShape.bucket_for(n_v, n_e, weighted=weighted)
        theirs = RefShape.bucket_for(n_v, n_e, weighted=weighted)
        assert (ours.n_vertices, ours.n_edges, ours.weighted) == \
            (theirs.n_vertices, theirs.n_edges, theirs.weighted)
    r19 = GraphShape.bucket_for(524288, 16777216)
    assert (r19.n_vertices, r19.n_edges) == (661395, 19719866)


def test_bucket_for_pads_and_binds():
    ref_g = ref_generators.uniform_random(200, 1200, seed=3)
    g = _carry(ref_g)
    shape = GraphShape.bucket_for(g.n_vertices, g.n_edges)
    padded = g.pad_to(shape.n_vertices, shape.n_edges)
    assert GraphShape.of(padded) == shape
    ref_prog, prog = _programs("BFS_ECP")
    acc = prog.lower(graph=g, bucket=True, device="cpu")
    ref_acc = ref_prog.lower(graph=ref_g, bucket=True)
    assert (acc.shape.n_vertices, acc.shape.n_edges) == \
        (ref_acc.shape.n_vertices, ref_acc.shape.n_edges) == (shape.n_vertices, shape.n_edges)
    got = acc.bind(padded).run(root=1)
    want = ref_acc.bind(ref_g.pad_to(shape.n_vertices, shape.n_edges)).run(root=1)
    _assert_parity("BFS_ECP", want, got)


# ---------------------------------------------------------------------------
# Logical vs padded counts (PageRank's teleport mass)
# ---------------------------------------------------------------------------


def test_pagerank_padded_matches_unpadded():
    ref_g = ref_generators.uniform_random(120, 700, seed=2)
    ref_prog, prog = _programs("PAGERANK")
    base = prog.bind(_carry(ref_g), device="cpu").run(iters=10)
    ref_padded, padded = _bucketed(120, 700, seed=2)
    got = prog.bind(padded, device="cpu").run(iters=10)
    np.testing.assert_allclose(got.properties["rank"][:120], base.properties["rank"],
                               rtol=1e-5, atol=1e-7)
    _assert_parity("PAGERANK", ref_prog.bind(ref_padded).run(iters=10), got)


# ---------------------------------------------------------------------------
# Monotonicity analysis (MIR-level)
# ---------------------------------------------------------------------------


MONOTONE_EXPECT = {
    "BFS_ECP": ("unit_distance", True),
    "BFS_HYBRID": ("unit_distance", True),
    "SSSP": ("weighted_distance", True),
    "WCC": ("label", True),
    "PAGERANK": (None, False),
    "PPR": (None, False),
    "CGAW": (None, False),
    "KCORE": (None, False),
}


@pytest.mark.parametrize("name", sorted(MONOTONE_EXPECT))
def test_analyze_incremental_verdicts(name):
    kind, monotone = MONOTONE_EXPECT[name]
    ref_prog, prog = _programs(name)
    info, want = analyze_incremental(prog.module), ref_analyze(ref_prog.module)
    assert info.monotone is monotone is want.monotone, info.reasons
    assert info.incremental_ok == want.incremental_ok
    assert tuple(info.reasons) == tuple(want.reasons)
    if monotone:
        assert info.incremental_ok and info.template.kind == kind
        t, w = info.template, want.template
        assert (t.kind, t.dist_prop, t.tuple_prop, tuple(t.mirror_props), t.round_scalar,
                t.unreached) == (w.kind, w.dist_prop, w.tuple_prop, tuple(w.mirror_props),
                                 w.round_scalar, w.unreached)
    else:
        assert not info.incremental_ok and info.reasons and info.template is None


# ---------------------------------------------------------------------------
# Incremental == from-scratch, and the port == the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("passes", ["default", "none"])
@pytest.mark.parametrize("algo", sorted(STREAM_CASES))
def test_incremental_matches_from_scratch_local(algo, passes):
    name, params, weighted = STREAM_CASES[algo]
    ref_prog, prog = _programs(name, passes)
    ref_g, g = _bucketed(weighted=weighted)
    rng = np.random.default_rng(11)
    # the reference through its accelerator (a plain reference session jits
    # again on every refresh), the port through a plain bind
    ref_ss = RefStreaming(ref_prog, ref_g, accelerator=ref_prog.lower(graph=ref_g))
    ss = StreamingSession(prog, g, device="cpu")
    try:
        _assert_parity(name, ref_ss.run(**params), ss.run(**params))
        for _ in range(3):
            rd, pd = _deltas(rng, ss.graph, 20, weighted=weighted)
            assert (ref_ss.update(rd), ss.update(pd)) == (ref_ss.version, ss.version)
            _same_graph(ref_ss.graph, ss.graph)
            want, got = ref_ss.run(**params), ss.run(**params)
            repaired = algo != "pagerank"
            _assert_parity(name, want, got, launches=not repaired)
            _assert_identical(got, prog.bind(ss.graph, device="cpu").run(**params))
            assert got.version == ss.version
            assert _counters(ss) == _counters(ref_ss)
        if algo == "pagerank":
            assert ss.incremental_runs == 0 and ss.full_runs == 4
        else:
            assert ss.incremental_runs == 3 and ss.full_runs == 1
    finally:
        ss.close()
        ref_ss.close()


@pytest.mark.parametrize("cache", [True, False])
def test_wcc_repair_equals_a_full_run_under_the_hub_relabel(cache):
    """WCC labels a vertex with its lane id (``comp[v] = v``), which under
    the hub relabel is its degree rank; an update moves the ranks. On an
    RMAT graph (isolated vertices and small components, so the ranks
    decide the labels) the repair renames each component by the refreshed
    ranks and equals a run from scratch, the reference's included. (The
    reference's own repair keeps the old ranks' labels there.)"""
    g = ref_generators.rmat(10, 8, seed=2)
    shape = RefShape.bucket_for(g.n_vertices, g.n_edges)
    ref_g = g.pad_to(shape.n_vertices, shape.n_edges)
    ref_prog, prog = _programs("WCC")
    target = repro_torch.Target(cache=cache)
    ss = StreamingSession(prog, _carry(ref_g), target=target, device="cpu")
    rng = np.random.default_rng(21)
    try:
        ss.run()
        for step in range(3):
            rd, pd = _deltas(rng, ss.graph, 64)
            ref_g.apply_updates(rd)
            ss.update(pd)
            got = ss.run()
            assert ss.incremental_runs == step + 1
            _assert_identical(got, ss.session.run())
            want = ref_prog.bind(ref_g, target=repro.Target(cache=cache)).run()
            want.version = ss.version
            _assert_parity("WCC", want, got, launches=False)
    finally:
        ss.close()


def test_pagerank_after_update_rebuilds_degrees():
    """PAGERANK reads ``out_degree``, uploaded once per bind: a refresh that
    kept the old buffer would divide by stale degrees. Additions with
    removals, under the default Target (hub relabel on)."""
    ref_prog, prog = _programs("PAGERANK")
    ref_g, g = _bucketed(seed=9)
    ref_sess, sess = ref_prog.bind(ref_g), prog.bind(g, device="cpu")
    before = sess.run(iters=8)
    real = np.flatnonzero(~g._free_slot_mask())[:30]
    rem = np.stack([g.src[real], g.dst[real]], axis=1)
    add = np.random.default_rng(2).integers(0, g.n_vertices_logical, size=(60, 2))
    ref_g.apply_updates(RefDelta(added_edges=add, removed_edges=rem))
    g.apply_updates(GraphDelta(added_edges=add, removed_edges=rem))
    ref_sess.refresh_graph(ref_g)
    sess.refresh_graph(g)
    got = sess.run(iters=8)
    assert not np.allclose(got.properties["rank"], before.properties["rank"])
    _assert_parity("PAGERANK", ref_sess.run(iters=8), got)
    _assert_identical(got, prog.bind(g, device="cpu").run(iters=8))


def test_removals_fall_back_to_full_recompute():
    ref_prog, prog = _programs("BFS_ECP")
    ref_g, g = _bucketed()
    ref_ss = RefStreaming(ref_prog, ref_g, accelerator=ref_prog.lower(graph=ref_g))
    ss = StreamingSession(prog, g, device="cpu")
    try:
        _assert_parity("BFS_ECP", ref_ss.run(root=3), ss.run(root=3))
        real = np.flatnonzero(~ss.graph._free_slot_mask())[:4]
        rem = np.stack([ss.graph.src[real], ss.graph.dst[real]], axis=1)
        ref_ss.update(RefDelta(removed_edges=rem))
        ss.update(GraphDelta(removed_edges=rem))
        got = ss.run(root=3)
        _assert_identical(got, prog.bind(ss.graph, device="cpu").run(root=3))
        _assert_parity("BFS_ECP", ref_ss.run(root=3), got)
        assert ss.incremental_runs == 0 and ss.full_runs == 2
        assert _counters(ss) == _counters(ref_ss)
    finally:
        ss.close()
        ref_ss.close()


def test_rebucket_on_overflow_is_transparent():
    ref_prog, prog = _programs("BFS_ECP")
    ref_g, g = _bucketed()
    ref_ss = RefStreaming(ref_prog, ref_g, accelerator=ref_prog.lower(graph=ref_g))
    acc = prog.lower(graph=g, device="cpu")
    ss = StreamingSession(prog, g, accelerator=acc)
    try:
        slack = ss.graph.n_edges - ss.graph.n_edges_logical
        rd, pd = _deltas(np.random.default_rng(0), ss.graph, slack + 16)
        ref_ss.update(rd)
        ss.update(pd)
        assert ss.rebuckets == 1 and ss.version == 1
        assert ss._accelerator is not acc and ss._accelerator.device == "cpu"
        assert ss._accelerator.shape == GraphShape.of(ss.graph)
        _same_graph(ref_ss.graph, ss.graph)
        got = ss.run(root=3)
        _assert_identical(got, prog.bind(ss.graph, device="cpu").run(root=3))
        _assert_parity("BFS_ECP", ref_ss.run(root=3), got)
        assert _counters(ss) == _counters(ref_ss)
    finally:
        ss.close()
        ref_ss.close()


def test_same_version_cache_hit_and_repair_reuse():
    _, prog = _programs("BFS_ECP")
    ss = StreamingSession(prog, _bucketed()[1], device="cpu")
    try:
        first = ss.run(root=3)
        assert ss.run(root=3) is first and ss.cache_hits == 1
        ss.update(_deltas(np.random.default_rng(1), ss.graph, 8)[1])
        repaired = ss.run(root=3)
        assert repaired is not first and ss.incremental_runs == 1
        assert ss.run(root=3) is repaired  # repaired result is re-cached
        assert repaired.version == 1 and repaired.stats.compile_time_s == 0.0
    finally:
        ss.close()


def test_non_local_backend_is_not_ported():
    """``backend="distributed"`` streams on the distributed engine, its
    repairs equal to the local session's; an unknown backend is refused."""
    _, prog = _programs("BFS_ECP")
    with pytest.raises(ValueError, match="unknown StreamingSession backend"):
        StreamingSession(prog, _bucketed()[1], backend="mesh", device="cpu")
    local = StreamingSession(prog, _bucketed()[1], device="cpu")
    dist = StreamingSession(prog, _bucketed()[1], backend="distributed", device="cpu")
    try:
        assert dist.target.kind == "distributed" and dist.backend == "distributed"
        delta = _deltas(np.random.default_rng(1), dist.graph, 8)[1]
        for ss in (local, dist):
            ss.run(root=3)
            ss.update(delta)
        got, want = dist.run(root=3), local.run(root=3)
        assert dist.incremental_runs == local.incremental_runs == 1
        for p in want.properties:
            np.testing.assert_array_equal(got.properties[p], want.properties[p], err_msg=p)
        assert got.host_env == want.host_env
    finally:
        local.close()
        dist.close()


# ---------------------------------------------------------------------------
# No re-lowering across in-bucket updates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("surface", ["accelerator", "plain"])
def test_in_bucket_update_performs_no_new_lowering(surface):
    """An accelerator's session keeps its warm keys across updates, as the
    reference's does. A plain bind's does too: its kernel library is
    shape-generic, so a refresh lowers nothing (the reference's plain
    engines jit again, and report it as compile time)."""
    ref_g = ref_generators.uniform_random(200, 1200, seed=6)
    g = _carry(ref_g)
    _, prog = _programs("BFS_ECP")
    shape = GraphShape.bucket_for(g.n_vertices, g.n_edges)
    padded = g.pad_to(shape.n_vertices, shape.n_edges)
    if surface == "accelerator":
        acc = prog.lower(graph=g, bucket=True, device="cpu")
        ss = StreamingSession(prog, padded, accelerator=acc)
    else:
        ss = StreamingSession(prog, padded, device="cpu")
    try:
        ss.run(root=0)  # warm-up
        library = ss.session.engine.library
        rng = np.random.default_rng(2)
        for step in range(3):
            ss.update(_deltas(rng, ss.graph, 10)[1])
            assert ss.session.engine.library is library
            warm = set(library.warm_keys)
            full = ss.run(root=step + 1)  # unseen param: a full run
            # compile time only for a frontier pad no earlier run touched
            new = set(library.warm_keys) - warm
            assert (full.stats.compile_time_s == 0.0) == (not new), new
            assert not any(k[0] == "full" for k in new)
            inc = ss.run(root=0)  # repaired: pure host work
            assert inc.stats.compile_time_s == 0.0
        assert ss.incremental_runs == 3 and ss.full_runs == 4 and ss.rebuckets == 0
    finally:
        ss.close()


# ---------------------------------------------------------------------------
# refresh_graph on every serving surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache", [True, False])
def test_session_refresh_graph_matches_reference_and_a_fresh_bind(cache):
    """The padding self-loops sit in one bin of 2,100 edges, which the work
    list cuts into 3 chunks of at most SPLIT_LEN (1,024); two deltas of 40
    additions shrink it to 2,020 edges, 2 chunks. So a refresh that kept
    the bind's list shows in the bindings (on the CPU the plain kernel
    versions take no list, and the answers alone cannot show it)."""
    ref_prog, prog = _programs("SSSP")
    ref_g = ref_generators.uniform_random(300, 1800, weighted=True, seed=5)
    ref_g = ref_g.pad_to(RefShape.bucket_for(300, 1800).n_vertices, 1800 + 2100)
    g = _carry(ref_g)
    ref_sess = ref_prog.bind(ref_g, target=repro.Target(cache=cache))
    sess = prog.bind(g, target=repro_torch.Target(cache=cache), device="cpu")
    _assert_parity("SSSP", ref_sess.run(root=2), sess.run(root=2))
    assert sess.engine.gb["es_split"].chunks.shape[0] == 3
    rng = np.random.default_rng(3)
    for _ in range(2):
        rd, pd = _deltas(rng, g, 40, weighted=True)
        ref_g.apply_updates(rd)
        g.apply_updates(pd)
        ref_sess.refresh_graph()
        sess.refresh_graph()
        got = sess.run(root=2)
        _assert_parity("SSSP", ref_sess.run(root=2), got)
        fresh = prog.bind(g, target=repro_torch.Target(cache=cache), device="cpu")
        _assert_identical(got, fresh.run(root=2))
        _assert_same_bindings(sess.engine, fresh.engine)
    assert sess.engine.gb["es_split"].chunks.shape[0] == 2


def _assert_same_bindings(engine, fresh):
    """Every graph binding, the work list's tensors included, and the
    degree and weight buffers of a refreshed engine equal a fresh bind's."""
    assert set(engine.gb) == set(fresh.gb)
    for key, want in fresh.gb.items():
        got = engine.gb[key]
        if isinstance(want, torch.Tensor):
            assert got.dtype == want.dtype and torch.equal(got, want), key
        elif isinstance(want, tuple) and want and isinstance(want[0], torch.Tensor):
            assert len(got) == len(want), key
            assert all(torch.equal(a, b) for a, b in zip(got, want)), key
        else:
            assert got == want, key
    assert set(engine._initial) == set(fresh._initial)
    for key, want in fresh._initial.items():
        assert torch.equal(engine._initial[key], want), key
    np.testing.assert_array_equal(engine.old2new, fresh.old2new)


@pytest.mark.parametrize("msbfs", [True, False])
def test_batch_session_after_refresh(msbfs):
    ref_prog, prog = _programs("BFS_ECP")
    ref_g, g = _bucketed(seed=8)
    sets = [{"root": r} for r in (0, 3, 7, 11, 40)]
    ref_bs = ref_prog.bind_batch(ref_g, msbfs=msbfs)
    bs = prog.bind_batch(g, device="cpu", msbfs=msbfs)
    sess = prog.bind(g, device="cpu")
    bs.run_many(sets)
    sess.run_many(sets)  # builds the session's batched twin
    rd, pd = _deltas(np.random.default_rng(4), g, 50)
    ref_g.apply_updates(rd)
    g.apply_updates(pd)
    ref_bs.refresh_graph()
    bs.refresh_graph()
    sess.refresh_graph()
    want = ref_bs.run_many(sets)
    got, twin = bs.run_many(sets), sess.run_many(sets)
    assert twin[0].stats.batch_size == len(sets)
    for p, w, a, b in zip(sets, want, got, twin):
        seq = sess.run(**p)
        _assert_identical(a, seq)
        _assert_identical(b, seq)
        _assert_parity("BFS_ECP", w, a, launches=False)
    assert got[0].stats.kernel_launches == want[0].stats.kernel_launches


def test_pool_refresh_graph_drains_its_batcher():
    _, prog = _programs("BFS_ECP")
    _, g = _bucketed(seed=12)
    roots = list(range(8))
    sess = prog.bind(g, device="cpu")
    before = [sess.run(root=r) for r in roots]
    pool = prog.pool(g, size=2, device="cpu", batch=4, batch_wait_s=0.05)
    try:
        futures = [pool.submit(root=r) for r in roots]
        g.apply_updates(_deltas(np.random.default_rng(6), g, 60)[1])
        pool.refresh_graph(g)  # drains the batcher before it rebinds
        assert all(f.done() for f in futures)
        for want, f in zip(before, futures):  # answered on the graph as submitted
            _assert_identical(f.result(), want)
        assert pool.batch_stats.batches >= 1
        sess.refresh_graph(g)
        after = [sess.run(root=r) for r in roots]
        assert any(not np.array_equal(a.properties["old_level"], b.properties["old_level"])
                   for a, b in zip(after, before))
        for want, got in zip(after, pool.run_batch([{"root": r} for r in roots])):
            _assert_identical(got, want)
        futures = [pool.submit(root=r) for r in roots]
        for want, f in zip(after, futures):
            _assert_identical(f.result(), want)
    finally:
        pool.close()
    with pytest.raises(repro_torch.ServiceClosed):
        pool.refresh_graph(g)


@pytest.mark.parametrize("name, params", [("CGAW", {}), ("SSSP", {"root": 2})])
def test_cpu_bind_does_not_alias_the_graph(name, params):
    """On the CPU the engine's buffers are copies: an in-place
    ``apply_updates`` without a refresh leaves a bound session on the graph
    it was bound to, as the card's copies do; the reference, bound to an
    unmutated twin, gives the answer. CGAW's float32 weight buffer shared
    the graph's array before the fix (SSSP's int32 one is a converted copy
    either way); CGAW overwrites its weights before it reads them, so the
    shared memory is what shows."""
    ref_prog, prog = _programs(name)
    ref_twin, g = _bucketed(weighted=True, seed=13)
    want = ref_prog.bind(ref_twin, target=repro.Target(cache=False)).run(**params)
    sess = prog.bind(g, target=repro_torch.Target(cache=False), device="cpu")
    _assert_parity(name, want, sess.run(**params))
    g.apply_updates(_deltas(np.random.default_rng(9), g, 40, weighted=True)[1])
    _assert_parity(name, want, sess.run(**params))
    tensors = [t for t in sess.engine.gb.values() if isinstance(t, torch.Tensor)]
    for t in tensors + list(sess.engine._initial.values()):
        for arr in (g.src, g.dst, g.weights):
            assert not np.shares_memory(t.numpy(), arr)


# ---------------------------------------------------------------------------
# Telemetry: the update and repair spans
# ---------------------------------------------------------------------------


def _span_attrs(spans, name):
    return [dict(sp.attrs) for sp in spans if sp.name == name]


def test_update_and_repair_spans_match_reference():
    import repro.telemetry as ref_tel

    ref_prog, prog = _programs("BFS_ECP")
    ref_g, g = _bucketed()
    ref_ss = RefStreaming(ref_prog, ref_g, accelerator=ref_prog.lower(graph=ref_g))
    ss = StreamingSession(prog, g, device="cpu")
    rng = np.random.default_rng(5)
    deltas = [_deltas(rng, g, 12) for _ in range(2)]
    spans = {}
    for key, session, module, pick in (("ref", ref_ss, ref_tel, 0), ("port", ss, tel, 1)):
        tracer = module.enable()
        try:
            session.run(root=3)
            for d in deltas:
                session.update(d[pick])
                session.run(root=3)
            spans[key] = tracer.spans()
        finally:
            module.disable()
            session.close()
    for name in ("update", "repair"):
        want, got = _span_attrs(spans["ref"], name), _span_attrs(spans["port"], name)
        assert len(got) == len(want) == 2, name
        for w, a in zip(want, got):
            assert set(a) == set(w), name
            for attr in set(w) - {"program"}:
                assert a[attr] == w[attr], (name, attr)
            assert a["program"] == prog.fingerprint[:16]
    assert [a["version"] for a in _span_attrs(spans["port"], "update")] == [1, 2]


# ---------------------------------------------------------------------------
# Concurrency: SessionPool queries racing update()
# ---------------------------------------------------------------------------


def test_concurrent_queries_never_observe_torn_versions():
    _, prog = _programs("BFS_ECP")
    ss = StreamingSession(prog, _bucketed()[1], pool_size=2, compact_every=0, device="cpu")
    try:
        ss.warmup(root=0)
        rng = np.random.default_rng(3)
        errors = []
        done = threading.Event()
        snapshots = {0: ss.graph.src.copy()}

        def updater():
            try:
                for _ in range(6):
                    ss.update(_deltas(rng, ss.graph, 6)[1])
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
        results = [f.result() for f in futures]
        assert {r.version for r in results} <= set(range(ss.version + 1))
        _assert_identical(ss.run(root=1), prog.bind(ss.graph, device="cpu").run(root=1))
        assert ss.updates == 6 and len(snapshots) == 1
    finally:
        ss.close()


# ---------------------------------------------------------------------------
# Property-based equivalence (hypothesis when available)
# ---------------------------------------------------------------------------


_REF_ACCS = {}


def _ref_accelerator(name, ref_g):
    """The reference's accelerator for one (program, bucket), lowered once."""
    key = (name, ref_g.n_vertices, ref_g.n_edges)
    if key not in _REF_ACCS:
        ref_prog = repro.compile(getattr(ref_sources, name))
        _REF_ACCS[key] = ref_prog.lower(graph=ref_g)
    return _REF_ACCS[key]


@settings(max_examples=10, deadline=None)
@given(
    seed=st.integers(min_value=0, max_value=2**31 - 1),
    n_deltas=st.integers(min_value=1, max_value=3),
    k=st.integers(min_value=1, max_value=30),
)
def test_random_deltas_preserve_equivalence(seed, n_deltas, k):
    rng = np.random.default_rng(seed)
    algo = ["bfs", "sssp", "wcc"][seed % 3]
    name, params, weighted = STREAM_CASES[algo]
    _, prog = _programs(name)
    ref_g, g = _bucketed(150, 900, weighted=weighted, seed=seed % 7)
    ss = StreamingSession(prog, g, device="cpu")
    try:
        ss.run(**params)
        for _ in range(n_deltas):
            rd, pd = _deltas(rng, ss.graph, k, weighted=weighted)
            ref_g.apply_updates(rd)
            ss.update(pd)
        got = ss.run(**params)
        _assert_identical(got, prog.bind(ss.graph, device="cpu").run(**params))
        want = _ref_accelerator(name, ref_g).bind(ref_g).run(**params)
        want.version = ss.version
        _assert_parity(name, want, got, launches=False)
        assert ss.incremental_runs >= 1
    finally:
        ss.close()


def test_hypothesis_compat_flag_is_boolean():
    assert HAVE_HYPOTHESIS in (True, False)
