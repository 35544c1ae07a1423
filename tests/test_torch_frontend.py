"""The port's front end and package boundary.

* The copied front end (lexer, parser, semantic analysis, MIR, passes)
  produces the same canonical MIR as the reference package for every
  program under both pass pipelines.
* ``repro_torch`` imports neither JAX nor the reference package.
* ``bind()`` picks the GPU by default and never falls back to the CPU.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.algorithms import sources as ref_sources
from repro.analysis import analyses as ref_analyses
from repro.core import mir as ref_mir
from repro.graph import generators as ref_generators
from repro_torch import analysis
from repro_torch.algorithms import sources
from repro_torch.core import mir

REPO = Path(__file__).resolve().parents[1]
PROGRAMS = ["BFS_ECP", "BFS_HYBRID", "PAGERANK", "SSSP", "PPR", "CGAW", "WCC", "KCORE"]


@pytest.mark.parametrize("passes", ["default", "none"])
@pytest.mark.parametrize("name", PROGRAMS)
def test_canonical_mir_matches_reference(name, passes):
    src = getattr(sources, name)
    assert src == getattr(ref_sources, name)
    ours = repro_torch.compile(src, repro_torch.CompileOptions(passes=passes))
    theirs = repro.compile(src, repro.CompileOptions(passes=passes))
    assert mir.canonical_serialize(ours.module) == ref_mir.canonical_serialize(theirs.module)
    assert mir.fingerprint(ours.module) == ref_mir.fingerprint(theirs.module)
    assert set(ours.params) == set(theirs.params)


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


@pytest.mark.parametrize("name", PROGRAMS + ["RACY"])
def test_race_analysis_matches_reference(name):
    """The trimmed race analysis gives the reference's GT101/GT102 findings,
    float-reduction set and forced-shuffle verdict, and the engine acts on
    it under the baseline Target as the reference's engine does."""
    src = RACY_GT if name == "RACY" else getattr(sources, name)
    ours = repro_torch.compile(src).module
    theirs = repro.compile(src).module
    got, got_float = analysis.race_analysis(ours)
    want, want_float = ref_analyses.race_analysis(theirs)
    assert [(d.code, d.severity, d.kernel, d.prop, d.line) for d in got] == \
        [(d.code, d.severity, d.kernel, d.prop, d.line) for d in want]
    assert got_float == want_float
    assert analysis.needs_shuffle(ours) == ref_analyses.needs_shuffle(theirs)
    assert analysis.needs_shuffle(ours) == (name == "RACY")
    g = repro_torch.graph_from_arrays(5, [0, 1, 2, 3], [1, 2, 3, 4], [1, 2, 3, 4])
    sess = repro_torch.compile(src).bind(g, target=repro_torch.Target.baseline(),
                                         device="cpu")
    assert sess.engine.shuffle_forced == (name == "RACY")
    assert sess.engine.target.shuffle == (name == "RACY")


def test_scalar_bindings_fold_like_reference():
    opts = (("damp", 0.5),)
    ours = repro_torch.compile(sources.PAGERANK,
                               repro_torch.CompileOptions(scalar_bindings=opts))
    theirs = repro.compile(sources.PAGERANK, repro.CompileOptions(scalar_bindings=opts))
    assert mir.canonical_serialize(ours.module) == ref_mir.canonical_serialize(theirs.module)
    assert "damp" not in ours.params


def test_import_pulls_in_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean', len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("clean")


def test_artifacts_and_tracing_import_neither_jax_nor_reference(tmp_path):
    """The accelerator and telemetry modules alone, then the whole artifact
    flow under tracing (whose deferred imports load the analysis, the
    session and the kernel build modules), load no JAX and no reference."""
    code = (
        "import sys\n"
        "import repro_torch.core.accelerator as acc_mod, repro_torch.telemetry as tel\n"
        "from repro_torch import compile, generators, load_accelerator, sources\n"
        "tel.enable()\n"
        "g = generators.power_law(100, 600, seed=1, weighted=True)\n"
        "acc = compile(sources.SSSP).lower(graph=g, device='cpu')\n"
        "acc.report().describe()\n"
        f"loaded = load_accelerator(acc.save({str(tmp_path / 'sssp')!r}), device='cpu')\n"
        "assert loaded.bind(g).run(root=0).trace is not None\n"
        "loaded.bind_batch(g).run_many([{'root': 0}, {'root': 1}])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean', len(tel.get().spans()))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("clean") and int(out.stdout.split()[1]) > 0


def test_streaming_imports_neither_jax_nor_reference():
    """A StreamingSession's update, repair and full run (its deferred
    imports load the passes' analysis and the sessions) load no JAX and
    no reference."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import repro_torch.streaming\n"
        "from repro_torch import GraphDelta, GraphShape, StreamingSession, compile, generators\n"
        "from repro_torch import sources\n"
        "g = generators.power_law(100, 600, seed=1)\n"
        "s = GraphShape.bucket_for(g.n_vertices, g.n_edges)\n"
        "ss = StreamingSession(compile(sources.WCC), g.pad_to(s.n_vertices, s.n_edges),\n"
        "                      device='cpu')\n"
        "ss.run()\n"
        "ss.update(GraphDelta(added_edges=np.array([[0, 5], [7, 9]])))\n"
        "assert ss.run().version == 1 and ss.incremental_runs == 1\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("clean")


def test_serving_analysis_and_autotune_import_neither_jax_nor_reference():
    """The embedded front end, the analysis package, lint, the serving tier,
    autotune and the algorithm helpers, imported alone and then driven (a
    served query, an embedded compile, a lint run, a tuner's candidates),
    load no JAX and no reference."""
    code = (
        "import sys\n"
        "import repro_torch.frontend, repro_torch.analysis, repro_torch.lint\n"
        "import repro_torch.serving, repro_torch.autotune, repro_torch.autotune.__main__\n"
        "import repro_torch.algorithms.embedded, repro_torch.algorithms.runners\n"
        "import repro_torch.launch.serve\n"
        "from repro_torch import analyze, compile, generators, serve\n"
        "from repro_torch.algorithms.embedded import BFS_ECP_EMBEDDED\n"
        "from repro_torch.autotune import AutoTuner, TuningCache\n"
        "g = generators.power_law(100, 600, seed=1)\n"
        "with serve(False, device='cpu') as svc:\n"
        "    svc.run(BFS_ECP_EMBEDDED, g, root=0)\n"
        "assert analyze(BFS_ECP_EMBEDDED).ok\n"
        "assert repro_torch.lint.main(['--builtins']) == 0\n"
        "AutoTuner(TuningCache()).candidates(compile(BFS_ECP_EMBEDDED), repro_torch.Target())\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.rstrip().endswith("clean")


def test_lm_stack_imports_neither_jax_nor_reference():
    """The config registry imports its arch modules by name: the port's
    copy must load ``repro_torch.configs.*``, never ``repro.configs.*``."""
    code = (
        "import sys\n"
        "import torch\n"
        "import repro_torch.models, repro_torch.configs, repro_torch.launch.serve\n"
        "from repro_torch.configs import ARCH_IDS, get_config, smoke_config\n"
        "cfgs = [get_config(a) for a in ARCH_IDS] + [smoke_config(a) for a in ARCH_IDS]\n"
        "assert {type(c).__module__ for c in cfgs} == {'repro_torch.configs.base'}\n"
        "m = repro_torch.models.Model(smoke_config('kimi-k2-1t-a32b'), torch.float32, 'cpu')\n"
        "m.init(torch.Generator().manual_seed(0))\n"
        "repro_torch.launch.serve.generate(m, torch.zeros(1, 2, dtype=torch.long), 2)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "arch = sorted(m for m in sys.modules if m.startswith('repro_torch.configs.'))\n"
        "print('clean', len(arch))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("clean")
    assert int(out.stdout.split()[1]) >= 12  # base, registry and the ten arch modules


def test_sources_name_no_jax_or_reference_import():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        assert not pattern.search(path.read_text()), path


def test_bind_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: bind() without a device uses it")
    g = repro_torch.generators.chain(6)
    prog = repro_torch.compile(sources.BFS_ECP)
    with pytest.raises(repro_torch.SessionError, match="no CUDA device"):
        prog.bind(g)
    with pytest.raises(repro_torch.SessionError, match="no CUDA device"):
        prog.bind(g, device="cuda")
    res = prog.bind(g, device="cpu").run(root=0)
    np.testing.assert_array_equal(res.properties["old_level"], np.arange(1, 7))


def test_bind_rejects_unknown_device():
    with pytest.raises(repro_torch.SessionError, match="unsupported device"):
        repro_torch.compile(sources.BFS_ECP).bind(repro_torch.generators.chain(4),
                                                  device="meta")


def test_run_validates_parameters():
    sess = repro_torch.compile(sources.BFS_ECP).bind(repro_torch.generators.chain(4),
                                                     device="cpu")
    with pytest.raises(repro_torch.ProgramError, match="unknown run-time parameter"):
        sess.run(rooot=0)
    with pytest.raises(repro_torch.ProgramError, match="expects int"):
        sess.run(root=1.5)


def test_front_end_errors_carry_a_location():
    bad = sources.BFS_ECP.replace("tuple[dst] min= level + 1;", "tuple[dst] min= ;")
    with pytest.raises(repro_torch.ProgramError) as exc:
        repro_torch.compile(bad)
    assert exc.value.line > 0 and "^" in str(exc.value)


def test_graph_from_arrays_carries_a_reference_graph():
    g = ref_generators.power_law(50, 300, seed=2, weighted=True)
    t = repro_torch.graph_from_arrays(g.n_vertices, g.src, g.dst, g.weights)
    assert t.n_vertices == g.n_vertices and t.weighted
    np.testing.assert_array_equal(t.src, g.src)
    np.testing.assert_array_equal(t.dst, g.dst)
    np.testing.assert_array_equal(t.weights, g.weights)
    for a, b in zip(t.csr, g.csr):
        np.testing.assert_array_equal(a, b)
    t2 = repro_torch.graph_from_arrays(3, torch.tensor([0, 1]), [1, 2])
    assert t2.src.dtype == np.int32 and t2.n_edges == 2 and not t2.weighted


def test_target_validates_and_has_no_kernel_knob():
    t = repro_torch.Target()
    assert hash(t) == hash(repro_torch.Target())
    assert not hasattr(t, "pallas") and not hasattr(t, "kernels")
    with pytest.raises(ValueError, match="kind"):
        repro_torch.Target(kind="mesh")
    assert repro_torch.Target(kind="distributed").kind == "distributed"
    with pytest.raises(ValueError, match="ablation"):
        repro_torch.Target.with_only("pallas")
    base = repro_torch.Target.baseline()
    assert not (base.burst or base.cache or base.shuffle or base.compact_frontier)
    assert repro_torch.Target.with_only("cache").cache
