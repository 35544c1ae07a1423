"""The port's embedded front end held to the reference's.

* The same builder code, run against each package's ``GraphProgram``,
  gives the same ``.gt`` emission and the same canonical MIR, and the
  emission round-trips through the port's text front end to the same MIR
  fingerprint.
* An embedded twin and its text resolve to one Program, one fingerprint
  and one cache entry; the twins' canonical MIR equals the reference's
  under both pass pipelines, and their results equal the reference's.
* Builder misuse and unsupported Python raise the same ``FrontendError``s
  as the reference, and compile wraps them in ``ProgramError``.
"""
import warnings

import numpy as np
import pytest

import repro
import repro.frontend as ref_fe
import repro_torch
import repro_torch.frontend as fe
from repro.algorithms import embedded as ref_embedded
from repro.core import mir as ref_mir
from repro_torch import CompileOptions, ProgramError, generators, sources
from repro_torch.algorithms import embedded
from repro_torch.core import mir, semantic
from repro_torch.core.parser import parse
from repro_torch.core.program import clear_program_cache, compile_program

# builtin stubs resolve by name inside kernel bodies: the same builder code
# lowers against either package's GraphProgram
from repro_torch.frontend import exp, leakyrelu, sigmoid, swap, to_float  # noqa: F401


def _skeleton(fe_mod, name="t"):
    p = fe_mod.GraphProgram(name)
    edges = p.edgeset("edges")
    vertices = p.vertexset("vertices")
    val = p.vertex_prop("val", int)
    return p, edges, vertices, val


def b_arith(fe_mod):
    p, edges, vertices, val = _skeleton(fe_mod)
    out = p.vertex_prop("out", int)

    @p.vertex_kernel
    def k(v):
        out[v] = (val[v] + 2) * 3 - val[v] / 2
        val[v] = -out[v]

    @p.main
    def main():
        vertices.process(k)

    return p


def b_boolops(fe_mod):
    p, edges, vertices, val = _skeleton(fe_mod)
    flag = p.vertex_prop("flag", int)

    @p.vertex_kernel
    def k(v):
        if (val[v] == 0) or (val[v] != 1) and (val[v] < 5):
            flag[v] = 1
        if (val[v] <= 2) and (val[v] > -3) or (val[v] >= 7):
            flag[v] = 2
        if not (val[v] == 4):  # noqa: SIM201 - exercises `not` lowering
            flag[v] = 3

    @p.main
    def main():
        vertices.process(k)

    return p


def b_reductions(fe_mod):
    p, edges, vertices, val = _skeleton(fe_mod)
    lo = p.vertex_prop("lo", int)
    hi = p.vertex_prop("hi", int)

    @p.edge_kernel
    def k(src, dst):
        lo[dst] = min(lo[dst], val[src])
        hi[dst] = max(val[src], hi[dst])
        val[dst] += 1
        lo[dst] -= 2
        hi[dst] *= 3

    @p.main
    def main():
        edges.process(k)

    return p


def b_if_elif(fe_mod):
    p, edges, vertices, val = _skeleton(fe_mod)

    @p.vertex_kernel
    def k(v):
        if val[v] == 0:
            val[v] = 1
        elif val[v] == 1:
            val[v] = 2
        else:
            val[v] = 3

    @p.main
    def main():
        vertices.process(k)

    return p


def b_accumulator(fe_mod):
    p, edges, vertices, val = _skeleton(fe_mod)
    total = p.vertex_prop("total", int)

    @p.edge_kernel
    def k(src, dst):
        val[dst] += 1
        total[0] = total[0] + 1

    @p.main
    def main():
        edges.process(k)

    return p


def b_neighbor_loop(fe_mod):
    p, edges, vertices, val = _skeleton(fe_mod)
    acc = p.vertex_prop("acc", int)

    @p.vertex_kernel
    def gather(v):
        for ngh in v.getNeighbors():
            acc[ngh] = min(acc[ngh], val[v])

    @p.main
    def main():
        vertices.process(gather)

    return p


def b_weighted(fe_mod):
    p = fe_mod.GraphProgram("w")
    edges = p.edgeset("edges", weight=float)
    p.vertexset("vertices")
    feat = p.vertex_prop("feat", float)

    @p.edge_kernel
    def score(src, dst, weight):
        weight = leakyrelu(feat[src] + feat[dst], 0.2)  # noqa: F841

    @p.main
    def main():
        edges.process(score)

    return p


def b_builtins(fe_mod):
    eps = 0.25  # captured Python float, inlined as a literal
    p = fe_mod.GraphProgram("b")
    p.edgeset("edges")
    vertices = p.vertexset("vertices")
    x = p.vertex_prop("x", float)

    @p.vertex_kernel
    def k(v):
        x[v] = sigmoid(exp(to_float(vertices.size()))) + abs(x[v]) - eps

    @p.main
    def main():
        vertices.process(k)

    return p


def b_host_control(fe_mod):
    p = fe_mod.GraphProgram("h")
    p.edgeset("edges")
    vertices = p.vertexset("vertices")
    a = p.vertex_prop("a", float)
    b = p.vertex_prop("b", float)
    iters = p.scalar("iters", int, init=3)
    thresh = p.scalar("thresh", float)

    @p.vertex_kernel
    def step(v):
        if a[v] > thresh:
            b[v] = a[v] * 0.5

    @p.main
    def main():
        vertices.init(step)
        i: int = 0
        while i < iters:
            vertices.process(step)
            swap(a, b)
            i = i + 1

    return p


def b_degrees_path(fe_mod):
    p = fe_mod.GraphProgram("d")
    edges = p.edgeset("edges", path="graph.el")
    vertices = p.vertexset("vertices")
    deg = p.vertex_prop("deg", int, init=edges.out_degrees())
    indeg = p.vertex_prop("indeg", int, init=edges.in_degrees())

    @p.vertex_kernel
    def k(v):
        deg[v] = deg[v] + indeg[v]

    @p.host
    def helper():
        vertices.process(k)

    @p.main
    def main():
        helper()

    return p


def b_edge_prop(fe_mod):
    p = fe_mod.GraphProgram("ep")
    p.edgeset("edges")
    vertices = p.vertexset("vertices")
    p.edge_prop("mark", int)
    val = p.vertex_prop("val", int)

    @p.vertex_kernel
    def k(v):
        val[v] = 0

    @p.main
    def main():
        vertices.process(k)

    return p


def b_python_name(fe_mod):
    p = fe_mod.GraphProgram("n")
    p.edgeset("edges")
    v_ = p.vertexset("vertices")
    renamed = p.vertex_prop("tuple", int)

    @p.vertex_kernel
    def k(v):
        renamed[v] = 0

    @p.main
    def main():
        v_.process(k)

    return p


BUILDERS = [b_arith, b_boolops, b_reductions, b_if_elif, b_accumulator, b_neighbor_loop,
            b_weighted, b_builtins, b_host_control, b_degrees_path, b_edge_prop,
            b_python_name]


@pytest.mark.parametrize("build", BUILDERS, ids=lambda b: b.__name__[2:])
def test_builder_matches_reference_and_round_trips(build):
    ours, theirs = build(fe), build(ref_fe)
    assert ours.to_source() == theirs.to_source()
    ours_mod = semantic.analyze(ours.to_fir())
    assert mir.canonical_serialize(ours_mod) == \
        ref_mir.canonical_serialize(repro.core.analyze(theirs.to_fir()))
    # embedded -> to_source() -> parse -> analyze: the same MIR hash
    assert ours.fingerprint() == mir.fingerprint(semantic.analyze(parse(ours.to_source())))
    assert ours.fingerprint() == theirs.fingerprint()


def test_builder_constructs_reach_the_mir():
    acc = semantic.analyze(b_accumulator(fe).to_fir())
    assert "total" in acc.kernels["k"].accumulators
    assert semantic.analyze(b_neighbor_loop(fe).to_fir()).kernels["gather"].has_neighbor_loop
    assert semantic.analyze(b_weighted(fe).to_fir()).kernels["score"].writes_weight
    deg = semantic.analyze(b_degrees_path(fe).to_fir())
    assert deg.degree_props == {"deg": "out", "indeg": "in"}
    assert "helper" in deg.host.host_funcs
    assert 'load("graph.el")' in b_degrees_path(fe).to_source()
    assert "lo[dst] min= val[src];" in b_reductions(fe).to_source()
    assert "0.25" in b_builtins(fe).to_source()
    assert "tuple[v] = 0;" in b_python_name(fe).to_source()
    prog = compile_program(b_host_control(fe))
    assert prog.params["thresh"].required and not prog.params["iters"].required


# ---------------------------------------------------------------------------
# the twins: one Program, the reference's MIR, the reference's answers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def graph():
    return generators.power_law(300, 2000, seed=7)


TWINS = [("BFS_ECP", "BFS_ECP_EMBEDDED"), ("PAGERANK", "PAGERANK_EMBEDDED")]


@pytest.mark.parametrize("passes", ["default", "none"])
@pytest.mark.parametrize("text,twin", TWINS)
def test_twin_and_text_are_one_program_with_the_reference_mir(text, twin, passes):
    opts = CompileOptions(passes=passes)
    p_twin = repro_torch.compile(getattr(embedded, twin), opts)
    p_text = repro_torch.compile(getattr(sources, text), opts)
    assert p_twin is p_text
    assert p_twin.fingerprint == p_text.fingerprint
    theirs = repro.compile(getattr(ref_embedded, twin), repro.CompileOptions(passes=passes))
    assert mir.canonical_serialize(p_twin.module) == \
        ref_mir.canonical_serialize(theirs.module)
    assert getattr(embedded, twin).to_source() == getattr(ref_embedded, twin).to_source()


def test_twins_share_one_cache_entry_and_the_memo():
    clear_program_cache()
    p_emb = repro_torch.compile(embedded.BFS_ECP_EMBEDDED)
    assert repro_torch.program_cache_info().currsize == 1
    assert repro_torch.compile(sources.BFS_ECP) is p_emb
    assert repro_torch.program_cache_info().currsize == 1
    assert repro_torch.compile(embedded.BFS_ECP_EMBEDDED,
                               CompileOptions(passes="none")) is not p_emb
    assert embedded.build_bfs_ecp().fingerprint() == embedded.BFS_ECP_EMBEDDED.fingerprint()
    assert embedded.build_pagerank().fingerprint() == \
        embedded.PAGERANK_EMBEDDED.fingerprint()
    # the source of an embedded-first compile is its .gt emission
    clear_program_cache()
    assert repro_torch.compile(embedded.PAGERANK_EMBEDDED).source == \
        embedded.PAGERANK_EMBEDDED.to_source()


def test_identity_memo_and_invalidation():
    p, edges, vertices, val = _skeleton(fe)

    @p.vertex_kernel
    def k(v):
        val[v] = 0

    @p.main
    def main():
        vertices.process(k)

    clear_program_cache()
    a = repro_torch.compile(p)
    assert p._identity is not None
    assert repro_torch.compile(p) is a
    extra = p.vertex_prop("extra", int)
    assert p._identity is None
    assert extra.name in repro_torch.compile(p, CompileOptions(passes="none")).source


@pytest.mark.parametrize("passes", ["default", "none"])
def test_twin_results_match_the_reference(graph, passes):
    ref_graph = repro.graph.generators.power_law(300, 2000, seed=7)
    opts, ref_opts = CompileOptions(passes=passes), repro.CompileOptions(passes=passes)
    clear_program_cache()
    bfs = repro_torch.compile(embedded.BFS_ECP_EMBEDDED, opts).bind(graph, device="cpu")
    ref_bfs = repro.compile(ref_embedded.BFS_ECP_EMBEDDED, ref_opts).bind(ref_graph)
    clear_program_cache()
    bfs_text = repro_torch.compile(sources.BFS_ECP, opts).bind(graph, device="cpu")
    for root in (0, 3):
        got = bfs.run(root=root).properties["old_level"]
        np.testing.assert_array_equal(got, np.asarray(
            ref_bfs.run(root=root).properties["old_level"]))
        np.testing.assert_array_equal(got, bfs_text.run(root=root).properties["old_level"])
    pr = repro_torch.compile(embedded.PAGERANK_EMBEDDED, opts).bind(graph, device="cpu")
    ref_pr = repro.compile(ref_embedded.PAGERANK_EMBEDDED, ref_opts).bind(ref_graph)
    got = pr.run(iters=5).properties["rank"]
    np.testing.assert_allclose(got, np.asarray(ref_pr.run(iters=5).properties["rank"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        got, repro_torch.compile(sources.PAGERANK, opts).bind(graph, device="cpu")
        .run(iters=5).properties["rank"])


def test_runners_accept_embedded_source(graph):
    from repro_torch.algorithms import run_bfs, run_pagerank, runners

    lv_emb, _ = run_bfs(graph, root=3, source=embedded.BFS_ECP_EMBEDDED, device="cpu")
    lv_txt, _ = run_bfs(graph, root=3, device="cpu")
    np.testing.assert_array_equal(lv_emb, lv_txt)
    pr_emb, _ = run_pagerank(graph, iters=5, source=embedded.PAGERANK_EMBEDDED, device="cpu")
    pr_txt, _ = run_pagerank(graph, iters=5, device="cpu")
    np.testing.assert_array_equal(pr_emb, pr_txt)
    assert isinstance(runners._ARGV, tuple)


def test_runners_match_the_reference_runners(graph):
    from repro.algorithms import runners as ref_runners
    from repro_torch.algorithms import runners

    ref_graph = repro.graph.generators.power_law(300, 2000, seed=7)
    for name, kw, exact in [("run_bfs", {"root": 2}, True), ("run_bfs_hybrid", {"root": 2}, True),
                            ("run_wcc", {}, True), ("run_kcore", {"k": 2}, True),
                            ("run_pagerank", {"iters": 4}, False),
                            ("run_ppr", {"source": 1, "max_iters": 5}, False)]:
        got, _ = getattr(runners, name)(graph, device="cpu", **kw)
        want, _ = getattr(ref_runners, name)(ref_graph, **kw)
        if exact:
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
        else:
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_make_warm_runner_is_deprecated_and_runs(graph):
    from repro_torch.algorithms.runners import make_warm_runner

    with pytest.warns(DeprecationWarning, match="repro_torch.run"):
        run = make_warm_runner(sources.BFS_ECP, graph, None, {"root": 0}, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        aot = make_warm_runner(embedded.BFS_ECP_EMBEDDED, graph, None, {"root": 0},
                               device="cpu", aot=True)
    np.testing.assert_array_equal(run().properties["old_level"],
                                  aot().properties["old_level"])
    assert aot.accelerator is not None and run.accelerator is None


def test_runners_need_a_gpu_without_a_device(graph):
    if repro_torch.core.session.torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device binds")
    from repro_torch.algorithms import run_bfs

    with pytest.raises(repro_torch.SessionError, match="no CUDA device"):
        run_bfs(graph, root=0)


# ---------------------------------------------------------------------------
# diagnostics: the reference's FrontendErrors, wrapped by compile
# ---------------------------------------------------------------------------


def _undeclared(fe_mod):
    p, edges, vertices, val = _skeleton(fe_mod)

    @p.vertex_kernel
    def bad(v):
        val[v] = undeclared_name  # noqa: F821


def _return(fe_mod):
    p, edges, vertices, val = _skeleton(fe_mod)

    @p.vertex_kernel
    def k1(v):
        return val[v]


def _chained(fe_mod):
    p, edges, vertices, val = _skeleton(fe_mod)

    @p.vertex_kernel
    def k2(v):
        if 0 < val[v] < 5:
            val[v] = 1


def _unannotated(fe_mod):
    p, edges, vertices, val = _skeleton(fe_mod)

    @p.main
    def m():
        x = 1  # noqa: F841 - missing `x: int = 1` annotation


def _arbitrary_call(fe_mod):
    p, edges, vertices, val = _skeleton(fe_mod)

    @p.vertex_kernel
    def k3(v):
        val[v] = len(val)


def _duplicate(fe_mod):
    p, edges, vertices, val = _skeleton(fe_mod)
    p.vertex_prop("val", int)


def _keyword(fe_mod):
    p, edges, vertices, val = _skeleton(fe_mod)
    p.vertex_prop("while", int)


def _two_edgesets(fe_mod):
    p, edges, vertices, val = _skeleton(fe_mod)
    p.edgeset("edges2")


def _unweighted(fe_mod):
    p, edges, vertices, val = _skeleton(fe_mod)

    @p.edge_kernel
    def k(src, dst, weight):
        weight = 1.0  # noqa: F841


def _outside_kernel(fe_mod):
    p, edges, vertices, val = _skeleton(fe_mod)
    val[0]


def _stub_call(fe_mod):
    fe_mod.to_float(1)


def _no_main(fe_mod):
    p, edges, vertices, val = _skeleton(fe_mod)
    p.to_fir()


def _second_main(fe_mod):
    p, edges, vertices, val = _skeleton(fe_mod)

    @p.vertex_kernel
    def ok(v):
        val[v] = 0

    @p.main
    def main():
        vertices.process(ok)

    @p.main
    def main2():
        vertices.process(ok)


def _foreign_handle(fe_mod):
    p1 = fe_mod.GraphProgram("one")
    p1.edgeset("edges")
    p1.vertexset("vertices")
    foreign = p1.vertex_prop("rank", float)
    p2, edges2, vertices2, val2 = _skeleton(fe_mod, "two")

    @p2.vertex_kernel
    def k(v):
        val2[v] = 0
        foreign[v] = 1.0


def _bad_path(fe_mod):
    fe_mod.GraphProgram("bad").edgeset("edges", path='a"b')


MISUSE = [(_undeclared, "undeclared_name"), (_return, "return"), (_chained, "chained"),
          (_unannotated, "undeclared"), (_arbitrary_call, "builtin"),
          (_duplicate, "duplicate"), (_keyword, "keyword"), (_two_edgesets, "one edgeset"),
          (_unweighted, "unweighted"), (_outside_kernel, "outside a decorated kernel"),
          (_stub_call, "device builtin"), (_no_main, "no @main"),
          (_second_main, "already has a @main"),
          (_foreign_handle, "belongs to GraphProgram 'one'"), (_bad_path, "escape")]


@pytest.mark.parametrize("case,match", MISUSE, ids=lambda c: getattr(c, "__name__", "")[1:])
def test_frontend_errors_match_the_reference(case, match):
    with pytest.raises(fe.FrontendError, match=match) as ours:
        case(fe)
    with pytest.raises(ref_fe.FrontendError) as theirs:
        case(ref_fe)
    assert str(ours.value) == str(theirs.value)
    assert (ours.value.filename, ours.value.lineno) == \
        (theirs.value.filename, theirs.value.lineno)


def test_embedded_error_reports_python_location():
    with pytest.raises(fe.FrontendError) as ei:
        _undeclared(fe)
    assert ei.value.filename.endswith(".py") and ei.value.lineno is not None
    assert f"{ei.value.filename}:{ei.value.lineno}" in str(ei.value)


def test_compile_wraps_embedded_errors_as_program_errors():
    p, edges, vertices, val = _skeleton(fe)  # no @main yet
    with pytest.raises(ProgramError, match="no @main"):
        repro_torch.compile(p)

    @p.vertex_kernel
    def k(v):
        while val[v] > 0:  # while is host-only: semantic rejection
            val[v] = 0

    @p.main
    def main():
        vertices.process(k)

    with pytest.raises(ProgramError, match="host-only") as ei:
        compile_program(p)
    assert ei.value.line > 0 and "Python source line" in str(ei.value)
    with pytest.raises(ProgramError, match="GraphProgram"):
        repro_torch.compile(42)
