"""The port's ``analyze``, lint and strict compile held to the reference's.

* ``repro_torch.analyze`` gives the reference's diagnostics (code,
  severity, message, kernel, property, line, column and the rendered
  provenance: a caret excerpt for text, ``file.py:lineno`` for embedded)
  on every fixture of the reference's tests, for both front ends, with
  and without a shape.
* The race analysis and the determinism certificate stay the reference's
  on all eight programs.
* ``compile(strict=True)``, ``Program.diagnostics()`` and
  ``GraphService.submit`` reject error-level programs.
* ``python -m repro_torch.lint`` prints what ``repro.lint`` prints and
  exits as it does.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro
import repro.frontend as ref_fe
import repro_torch
import repro_torch.frontend as fe
from repro import analysis as ref_analysis
from repro.algorithms import embedded as ref_embedded
from repro.algorithms import sources as ref_sources
from repro_torch import analysis
from repro_torch.algorithms import embedded, sources
from repro_torch.core.accelerator import GraphShape

REPO = Path(__file__).resolve().parents[1]
PROGRAMS = ["BFS_ECP", "BFS_HYBRID", "PAGERANK", "SSSP", "PPR", "CGAW", "WCC", "KCORE"]

RACY_GT = """
element Vertex end
const edges: edgeset{Vertex}(Vertex, Vertex) = load(argv(1));
const vertices: vertexset{Vertex};
const P: vector{Vertex}(int);
func initP(v: Vertex)
    P[v] = 0;
end
func upd(src: Vertex, dst: Vertex)
    P[dst] = P[src] + 1;
end
func main()
    vertices.init(initP);
    edges.process(upd);
end
"""

GT102_GT = """
element Vertex end
const edges: edgeset{Vertex}(Vertex, Vertex) = load(argv(1));
const vertices: vertexset{Vertex};
const P: vector{Vertex}(int);
func initP(v: Vertex)
    P[v] = 0;
end
func upd(src: Vertex, dst: Vertex)
    P[dst] += 1;
    P[dst] min= src;
end
func main()
    vertices.init(initP);
    edges.process(upd);
end
"""

UNINIT_GT = """
element Vertex end
const edges: edgeset{Vertex}(Vertex, Vertex) = load(argv(1));
const vertices: vertexset{Vertex};
const seen: vector{Vertex}(int);
const orphan: vector{Vertex}(int);
func touch(v: Vertex)
    orphan[v] = seen[v] + 1;
end
func main()
    vertices.process(touch);
end
"""

NONTERM_GT = """
element Vertex end
const edges: edgeset{Vertex}(Vertex, Vertex) = load(argv(1));
const vertices: vertexset{Vertex};
const lvl: vector{Vertex}(int);
const acc: vector{Vertex}(int);
func init(v: Vertex)
    lvl[v] = 0;
end
func relax(src: Vertex, dst: Vertex)
    if (lvl[src] == 1)
        acc[dst] min= lvl[src];
    end
end
func main()
    vertices.init(init);
    var stuck: int = 1;
    while (stuck > 0)
        edges.process(relax);
    end
end
"""


def build_racy(fe_mod):
    """The embedded twin of RACY_GT (same kernels, same race)."""
    g = fe_mod.GraphProgram("racy_twin")
    edges = g.edgeset("edges")
    vertices = g.vertexset("vertices")
    P = g.vertex_prop("P", int)

    @g.vertex_kernel
    def initP(v):
        P[v] = 0

    @g.edge_kernel
    def upd(src, dst):
        P[dst] = P[src] + 1

    @g.main
    def main():
        vertices.init(initP)
        edges.process(upd)

    return g


def build_gt102(fe_mod):
    g = fe_mod.GraphProgram("gt102_twin")
    edges = g.edgeset("edges")
    vertices = g.vertexset("vertices")
    P = g.vertex_prop("P", int)

    @g.vertex_kernel
    def initP(v):
        P[v] = 0

    @g.edge_kernel
    def upd(src, dst):
        P[dst] += 1
        P[dst] = min(P[dst], src)

    @g.main
    def main():
        vertices.init(initP)
        edges.process(upd)

    return g


def build_uninit(fe_mod):
    g = fe_mod.GraphProgram("uninit_twin")
    g.edgeset("edges")
    vertices = g.vertexset("vertices")
    seen = g.vertex_prop("seen", int)
    orphan = g.vertex_prop("orphan", int)

    @g.vertex_kernel
    def touch(v):
        orphan[v] = seen[v] + 1

    @g.main
    def main():
        vertices.process(touch)

    return g


def build_nonterm(fe_mod):
    g = fe_mod.GraphProgram("nonterm_twin")
    edges = g.edgeset("edges")
    vertices = g.vertexset("vertices")
    lvl = g.vertex_prop("lvl", int)
    acc = g.vertex_prop("acc", int)

    @g.vertex_kernel
    def init(v):
        lvl[v] = 0

    @g.edge_kernel
    def relax(src, dst):
        if lvl[src] == 1:
            acc[dst] = min(acc[dst], lvl[src])

    @g.main
    def main():
        vertices.init(init)
        stuck: int = 1
        while stuck > 0:
            edges.process(relax)

    return g


# (name, text, embedded builder or None, expected codes among the findings)
FIXTURES = [
    ("racy", RACY_GT, build_racy, {"GT101"}),
    ("gt102", GT102_GT, build_gt102, {"GT102"}),
    ("uninit_dead", UNINIT_GT, build_uninit, {"GT301", "GT302"}),
    ("nonterm", NONTERM_GT, build_nonterm, {"GT401", "GT402"}),
    ("broken", "func main( end", None, {"GT002"}),
    ("lex_error", "element Vertex end\nconst $bad: int = 1;\n", None, {"GT001"}),
]

SHAPES = [None, (100, 1000), (100, 2**31 - 1), (100, 2**31)]


def _package_neutral(text: str) -> str:
    """An embedded program's provenance names its defining file: the port's
    twins live in the port's package, the reference's in the reference's."""
    return text.replace(os.sep + "repro_torch" + os.sep, os.sep + "repro" + os.sep)


def _records(result):
    return [dict(d.to_dict(), location=_package_neutral(d.location))
            for d in result.diagnostics]


def _same(ours, theirs):
    assert _records(ours) == _records(theirs)
    assert ours.certificate == theirs.certificate
    assert ours.fingerprint == theirs.fingerprint
    assert _package_neutral(ours.render()) == theirs.render()


# a lex or parse error has no embedded twin
CASES = [(f, "text") for f in FIXTURES] + [(f, "embedded") for f in FIXTURES if f[2]]


@pytest.mark.parametrize("fixture,frontend", CASES, ids=[f"{f[0]}-{e}" for f, e in CASES])
def test_fixture_diagnostics_match_the_reference(fixture, frontend):
    name, text, build, codes = fixture
    if frontend == "embedded":
        ours, theirs = analysis.analyze(build(fe)), ref_analysis.analyze(build(ref_fe))
    else:
        ours, theirs = analysis.analyze(text), ref_analysis.analyze(text)
    _same(ours, theirs)
    assert codes <= set(ours.codes())


def test_front_ends_give_the_same_codes():
    for _, text, build, _codes in FIXTURES:
        if build is not None:
            assert analysis.analyze(text).codes() == analysis.analyze(build(fe)).codes()


@pytest.mark.parametrize("shape", SHAPES, ids=["none", "small", "e_int32_max", "e_2^31"])
@pytest.mark.parametrize("name", PROGRAMS)
def test_programs_match_the_reference_with_and_without_a_shape(name, shape):
    src = getattr(sources, name)
    ours = analysis.analyze(src, shape=GraphShape(*shape) if shape else None)
    theirs = ref_analysis.analyze(
        src, shape=repro.core.accelerator.GraphShape(*shape) if shape else None)
    _same(ours, theirs)
    if shape is None:
        assert ours.ok and not ours.warnings


@pytest.mark.parametrize("twin", ["BFS_ECP_EMBEDDED", "PAGERANK_EMBEDDED"])
def test_twins_match_the_reference(twin):
    text = getattr(sources, twin.replace("_EMBEDDED", ""))
    assert analysis.analyze(getattr(embedded, twin)).codes() == analysis.analyze(text).codes()
    _same(analysis.analyze(getattr(embedded, twin)),
          ref_analysis.analyze(getattr(ref_embedded, twin)))


@pytest.mark.parametrize("name", PROGRAMS + ["RACY", "GT102"])
def test_race_analysis_and_certificate_are_unchanged(name):
    """The engine's forced-shuffle verdict and the reports' certificate
    (the trimmed module's two jobs until this slice) stay the reference's."""
    src = {"RACY": RACY_GT, "GT102": GT102_GT}.get(name) or getattr(sources, name)
    ours = repro_torch.compile(src).module
    theirs = repro.compile(src).module
    assert analysis.needs_shuffle(ours) == ref_analysis.needs_shuffle(theirs)
    assert analysis.determinism_certificate(ours) == \
        ref_analysis.determinism_certificate(theirs)
    assert analysis.certificate_info(ours) == ref_analysis.certificate_info(theirs)
    got, got_float = analysis.race_analysis(ours)
    want, want_float = ref_analysis.race_analysis(theirs)
    assert [d.to_dict() for d in got] == [d.to_dict() for d in want]
    assert got_float == want_float
    g = repro_torch.graph_from_arrays(5, [0, 1, 2, 3], [1, 2, 3, 4], [1, 2, 3, 4])
    sess = repro_torch.compile(src).bind(g, target=repro_torch.Target.baseline(),
                                         device="cpu")
    assert sess.engine.shuffle_forced == analysis.needs_shuffle(ours)


def test_registry_of_codes_is_the_reference():
    assert analysis.CODES == ref_analysis.CODES
    assert analysis.SEVERITIES == ref_analysis.SEVERITIES


def test_text_and_embedded_provenance():
    (err,) = analysis.analyze(RACY_GT).errors
    assert err.code == "GT101" and err.kernel == "upd" and err.prop == "P"
    assert "P[dst] = P[src] + 1;" in err.location and "^" in err.location
    assert err.line == RACY_GT.splitlines().index("    P[dst] = P[src] + 1;") + 1
    (err,) = analysis.analyze(build_racy(fe)).errors
    assert err.location.endswith(f":{err.line}")
    assert os.path.basename(__file__) in err.location
    assert "P[dst] = P[src] + 1" in open(__file__).read().splitlines()[err.line - 1]


# ---------------------------------------------------------------------------
# strict compile, Program.diagnostics, admission
# ---------------------------------------------------------------------------


def test_strict_compile_rejects_on_both_paths_and_both_front_ends():
    with pytest.raises(repro_torch.ProgramError) as ei:
        repro_torch.compile(RACY_GT, strict=True)
    assert "GT101" in str(ei.value) and ei.value.line > 0
    assert repro_torch.compile(RACY_GT) is not None  # non-strict primes the cache
    with pytest.raises(repro_torch.ProgramError):
        repro_torch.compile(RACY_GT, strict=True)  # cache-hit path
    with pytest.raises(repro_torch.ProgramError) as ei:
        repro_torch.compile(build_racy(fe), strict=True)
    assert os.path.basename(__file__) in str(ei.value)
    assert repro_torch.compile(sources.BFS_ECP, strict=True) is \
        repro_torch.compile(sources.BFS_ECP)
    # warnings do not raise under strict
    assert repro_torch.compile(UNINIT_GT, strict=True).diagnostics().warnings


def test_program_diagnostics_is_cached_and_takes_a_shape():
    prog = repro_torch.compile(RACY_GT)
    res = prog.diagnostics()
    assert "GT101" in res.codes() and res.fingerprint == prog.fingerprint
    assert prog.diagnostics() is res
    ref = repro.compile(RACY_GT).diagnostics()
    assert _records(res) == _records(ref)
    kcore = repro_torch.compile(sources.KCORE)
    big = kcore.diagnostics(shape=GraphShape(100, 2**31))
    assert "GT502" in big.codes() and not big.ok
    assert kcore.diagnostics().ok


def test_service_rejects_racy_programs_before_any_bind():
    g = repro_torch.graph_from_arrays(4, [0, 1, 2, 0], [1, 2, 0, 2])
    with repro_torch.serve(False, device="cpu") as svc:
        for program in (RACY_GT, build_racy(fe), GT102_GT):
            with pytest.raises(repro_torch.ProgramRejected) as ei:
                svc.submit(program, g, tenant="alice")
            assert ei.value.diagnostics and all(d.severity == "error"
                                                for d in ei.value.diagnostics)
        assert [d.code for d in ei.value.diagnostics] == ["GT102"]
        stats = svc.stats()
        assert stats["tenants"]["alice"]["rejections_analysis"] == 3
        assert stats["queries"]["submitted"] == 0
        assert svc.registry.lowerings == 0 and svc.registry.info()["resident"] == 0
        assert svc.run("bfs", g, tenant="alice", root=0) is not None
    assert issubclass(repro_torch.ProgramRejected, repro_torch.ServingError)


# ---------------------------------------------------------------------------
# the lint CLI
# ---------------------------------------------------------------------------


def _both(args, capsys):
    from repro.lint import main as ref_main
    from repro_torch.lint import main

    rc = main(args)
    ours = capsys.readouterr().out
    ref_rc = ref_main(args)
    theirs = capsys.readouterr().out
    return rc, ours, ref_rc, theirs


def test_lint_text_output_and_exit_codes_match(tmp_path, capsys):
    good = tmp_path / "good.gt"
    good.write_text(sources.BFS_ECP)
    racy = tmp_path / "racy.gt"
    racy.write_text(RACY_GT)
    for args, want in [([str(good)], 0), ([str(good), str(racy)], 1)]:
        rc, ours, ref_rc, theirs = _both(args, capsys)
        assert rc == ref_rc == want
        assert ours == theirs
    assert "GT101" in ours


def test_lint_json_matches(tmp_path, capsys):
    racy = tmp_path / "racy.gt"
    racy.write_text(RACY_GT)
    rc, ours, ref_rc, theirs = _both(["--json", str(racy)], capsys)
    assert rc == ref_rc == 1
    assert json.loads(ours) == json.loads(theirs)
    (target,) = json.loads(ours)["targets"].values()
    assert target["certificate"] == analysis.RACY


def test_lint_builtins_match(capsys):
    rc, ours, ref_rc, theirs = _both(["--json", "--builtins"], capsys)
    assert rc == ref_rc == 0
    doc = json.loads(ours)
    assert json.loads(_package_neutral(ours)) == json.loads(theirs)
    assert doc["ok"] is True and len(doc["targets"]) == 10


def test_lint_module_specs(capsys):
    from repro_torch.lint import main

    assert main(["repro_torch.algorithms.sources:WCC"]) == 0
    assert main(["repro_torch.algorithms.embedded:build_pagerank"]) == 0
    assert main(["tests.test_torch_analysis:RACY_GT"]) == 1
    with pytest.raises(SystemExit, match="neither a .gt file"):
        main(["nonsense"])
    capsys.readouterr()


def test_lint_cli_runs_as_a_module(tmp_path):
    racy = tmp_path / "racy.gt"
    racy.write_text(RACY_GT)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.lint", "--json", str(racy)],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 1, out.stderr[-2000:]
    assert json.loads(out.stdout)["ok"] is False
    ok = subprocess.run([sys.executable, "-m", "repro_torch.lint", "--builtins"],
                        capture_output=True, text=True, env=env, timeout=120)
    assert ok.returncode == 0, ok.stderr[-2000:]
    assert "lint: 10 target(s), 0 error(s), 0 warning(s)" in ok.stdout


def test_builtin_sources_are_the_references():
    for name in PROGRAMS:
        assert getattr(sources, name) == getattr(ref_sources, name)
