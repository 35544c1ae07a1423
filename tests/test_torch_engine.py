"""The port's main path as a whole against the reference package.

Every program of ``algorithms/sources.py`` runs through
``compile(src).bind(g).run(**params)`` in both packages on one graph
(numpy-seeded, carried across with ``graph_from_arrays``), under passes
default/none with the default Target, and with passes default under the
baseline and single-optimization Targets. The port runs on the CPU, where
its kernel wrappers take their plain PyTorch versions.

* BFS_ECP, BFS_HYBRID, SSSP, WCC, KCORE (min/max/int): properties and
  host scalars bit-exact.
* PAGERANK, PPR, CGAW (float sums, exp/sigmoid): properties allclose with
  ``rtol=1e-5, atol=1e-6`` (sums are taken in another order than XLA's),
  host scalars equal.
* Launch accounting equal: per-kernel launches, compacted, full and fused
  launches.
"""
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.algorithms import sources as ref_sources
from repro.core import backend as jax_backend
from repro.graph import generators as ref_generators
from repro_torch.algorithms import sources
from repro_torch.core import backend

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
CONFIGS = [
    ("default", None), ("none", None), ("default", "baseline"),
    ("default", "burst"), ("default", "cache"), ("default", "shuffle"),
]


@pytest.fixture(scope="module")
def graphs():
    g = ref_generators.power_law(200, 1400, seed=5, weighted=True)
    return g, repro_torch.graph_from_arrays(g.n_vertices, g.src, g.dst, g.weights,
                                            n_vertices_logical=g.n_vertices_logical,
                                            n_edges_logical=g.n_edges_logical)


def _targets(knob):
    if knob is None:
        return None, None
    if knob == "baseline":
        return repro.Target.baseline(), repro_torch.Target.baseline()
    return repro.Target.with_only(knob), repro_torch.Target.with_only(knob)


def _run_both(graphs, algo, passes, knob):
    g, tg = graphs
    name, params = ALGORITHMS[algo]
    ref_target, target = _targets(knob)
    ref_prog = repro.compile(getattr(ref_sources, name), repro.CompileOptions(passes=passes))
    ref_sess = ref_prog.bind(g) if ref_target is None else ref_prog.bind(g, target=ref_target)
    prog = repro_torch.compile(getattr(sources, name), repro_torch.CompileOptions(passes=passes))
    return ref_sess.run(**params), prog.bind(tg, target=target, device="cpu").run(**params)


def _assert_parity(algo, want, got):
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
    assert gs.compacted_launches == ws.compacted_launches
    assert gs.full_launches == ws.full_launches
    assert gs.fused_launches == ws.fused_launches
    assert gs.edges_traversed == ws.edges_traversed
    assert gs.host_iterations == ws.host_iterations


@pytest.mark.parametrize("passes,knob", CONFIGS)
@pytest.mark.parametrize("algo", list(ALGORITHMS))
def test_port_matches_reference(graphs, algo, passes, knob):
    want, got = _run_both(graphs, algo, passes, knob)
    _assert_parity(algo, want, got)


PADDED_TARGETS = {
    "default": lambda T: None, "baseline": lambda T: T.baseline(),
    "partition_vertices=16": lambda T: T(partition_vertices=16),
    "compact_frontier=False": lambda T: T(compact_frontier=False),
    "cache=False": lambda T: T(cache=False),
}


@pytest.fixture(scope="module")
def padded_graphs():
    """A graph padded to a shape bucket (300 real vertices in 512, 2000 real
    edges in 4096), carried across with its logical counts."""
    g = ref_generators.power_law(300, 2000, seed=7).pad_to(512, 4096)
    tg = repro_torch.graph_from_arrays(g.n_vertices, g.src, g.dst, g.weights,
                                       n_vertices_logical=g.n_vertices_logical,
                                       n_edges_logical=g.n_edges_logical)
    return g, tg


@pytest.mark.parametrize("target", list(PADDED_TARGETS))
@pytest.mark.parametrize("algo", ["pagerank", "ppr"])
def test_padded_graph_keeps_its_logical_counts(padded_graphs, algo, target):
    """PAGERANK and PPR normalise by ``vertices.size()``, the logical count:
    on a padded graph carried across with its logical counts the port
    matches the reference under every Target (it normalised by the padded
    512 while ``graph_from_arrays`` dropped them)."""
    g, tg = padded_graphs
    assert (tg.n_vertices, tg.n_vertices_logical) == (512, 300)
    assert (tg.n_edges, tg.n_edges_logical) == (g.n_edges, g.n_edges_logical)
    name, params = ALGORITHMS[algo]
    ref_target = PADDED_TARGETS[target](repro.Target)
    ref_prog = repro.compile(getattr(ref_sources, name))
    want = (ref_prog.bind(g) if ref_target is None else ref_prog.bind(g, target=ref_target)
            ).run(**params)
    got = repro_torch.compile(getattr(sources, name)).bind(
        tg, target=PADDED_TARGETS[target](repro_torch.Target), device="cpu").run(**params)
    assert set(got.properties) == set(want.properties)
    for prop, a in want.properties.items():
        if a.dtype == np.float32:
            np.testing.assert_allclose(got.properties[prop], a, rtol=1e-5, atol=1e-6,
                                       err_msg=prop)
        else:
            np.testing.assert_array_equal(got.properties[prop], a, err_msg=prop)
    assert got.host_env == want.host_env


def test_graph_from_arrays_defaults_to_the_physical_counts(padded_graphs):
    """Without the two counts a graph is its own logical graph, as before."""
    g, _ = padded_graphs
    tg = repro_torch.graph_from_arrays(g.n_vertices, g.src, g.dst, g.weights)
    assert (tg.n_vertices_logical, tg.n_edges_logical) == (g.n_vertices, g.n_edges) == (512, 4096)


def test_session_reruns_are_identical(graphs):
    _, tg = graphs
    sess = repro_torch.compile(sources.SSSP).bind(tg, device="cpu")
    a = sess.run(root=3)
    b = sess.run(root=5)
    c = sess.run(root=3)
    assert sess.runs == 3
    for k in a.properties:
        np.testing.assert_array_equal(a.properties[k], c.properties[k])
    assert not np.array_equal(a.properties["SP"], b.properties["SP"])


def test_unwritten_bind_buffers_are_copied_to_the_host_once(graphs):
    """Weights no kernel writes come back as one read-only host copy per
    bind; weights a program writes (CGAW) are read back on every run."""
    _, tg = graphs
    sess = repro_torch.compile(sources.SSSP).bind(tg, device="cpu")
    a, b = sess.run(root=3), sess.run(root=5)
    assert a.properties["weight"] is b.properties["weight"]
    assert not a.properties["weight"].flags.writeable
    np.testing.assert_array_equal(a.properties["weight"], tg.weights)
    cgaw = repro_torch.compile(sources.CGAW).bind(tg, device="cpu")
    c, d = cgaw.run(), cgaw.run()
    assert c.properties["weight"] is not d.properties["weight"]
    np.testing.assert_array_equal(c.properties["weight"], d.properties["weight"])


@pytest.mark.parametrize("name,apply_op,op", [
    ("BFS_ECP", "src", "min"), ("BFS_HYBRID", "src", "min"), ("SSSP", "add", "min"),
    ("PAGERANK", "src", "+"), ("PPR", "src", "+"),
])
def test_edge_stream_route_matches_the_main_edge_kernels(name, apply_op, op):
    prog = repro_torch.compile(getattr(sources, name))
    plans = [backend.edge_stream_plan(prog.module, k) for k in prog.module.kernels.values()
             if isinstance(k, repro_torch.core.mir.Kernel)]
    plans = [p for p in plans if p is not None]
    assert len(plans) == 1
    assert (plans[0].apply_op, plans[0].op) == (apply_op, op)


@pytest.mark.parametrize("name", ["WCC", "KCORE", "CGAW"])
def test_edge_stream_route_skips_other_edge_kernels(name):
    prog = repro_torch.compile(getattr(sources, name))
    for k in prog.module.kernels.values():
        if isinstance(k, repro_torch.core.mir.Kernel):
            assert backend.edge_stream_plan(prog.module, k) is None, k.name


def test_edge_stream_route_forms():
    """E + weight, weight + E and E * weight match; a dst read, an edge
    weight in the guard, or '-' with a weight do not."""
    head = sources.SSSP.split("func relax")[0]
    tail = "func main()\n    edges.process(relax);\nend\n"
    cases = {
        "tuple[dst] min= (SP[src] + weight);": ("add", "min"),
        "tuple[dst] min= (weight + SP[src]);": ("add", "min"),
        "tuple[dst] max= (SP[src] * weight);": ("mul", "max"),
        "tuple[dst] += SP[src];": ("src", "+"),
        "tuple[dst] -= SP[src];": ("src", "+"),
        "tuple[dst] min= (SP[dst] + weight);": None,
        "tuple[dst] -= (SP[src] + weight);": None,
        "tuple[src] min= (SP[src] + weight);": None,
    }
    for body, want in cases.items():
        src = head + f"func relax(src: Vertex, dst: Vertex, weight: int)\n    {body}\nend\n" + tail
        prog = repro_torch.compile(src, repro_torch.CompileOptions(passes="none"))
        plan = backend.edge_stream_plan(prog.module, prog.module.kernels["relax"])
        got = None if plan is None else (plan.apply_op, plan.op)
        assert got == want, body


def test_frontier_builder_matches_reference():
    """The compacted-launch expansion: same edges in the valid lanes as the
    reference's jitted builder, with padded lanes kept in range."""
    g = ref_generators.power_law(300, 2500, seed=9, weighted=True)
    indptr, csr_idx, csr_eids = g.csr
    deg = np.diff(indptr).astype(np.int32)
    starts = indptr[:-1].astype(np.int32)
    mask = np.random.default_rng(0).random(g.n_vertices) < 0.1
    n_active, n_edges = int(mask.sum()), int(deg[mask].sum())
    pad_v, pad_e = 1024, 1024
    ref_build = jax_backend.make_frontier_builder(g.n_vertices, g.n_edges, True)
    want = ref_build(deg, starts, csr_idx, csr_eids, mask, g.weights, pad_v=pad_v, pad_e=pad_e)
    build = backend.make_frontier_builder(g.n_vertices, g.n_edges, True)
    t = torch.from_numpy
    got = build(t(deg), t(starts), t(csr_idx), t(csr_eids), t(mask), t(g.weights),
                pad_v, pad_e, n_edges)
    valid = np.asarray(want[4])
    np.testing.assert_array_equal(got[4].numpy(), valid)
    assert valid.sum() == n_edges and n_active > 0
    for a, b in zip(want[:4], got[:4]):
        np.testing.assert_array_equal(b.numpy()[valid], np.asarray(a)[valid])
    for arr, hi in zip(got[:4], (g.n_vertices, g.n_vertices, None, g.n_edges)):
        if hi is not None:
            assert int(arr.min()) >= 0 and int(arr.max()) < hi
