"""The port's tracing against the reference's: span trees, exporters,
profile persistence and sampling.

The golden span tree runs the reference's flow and the port's on one
graph (``power_law(300, 2400, seed=2)``, carried across with
``graph_from_arrays``; the port on the CPU), BFS_ECP root 3: compile ->
lower -> bind -> run. The ordered list of ``(name, kernel, kind,
direction, mode, edges)`` over the launch spans must be EQUAL to the
reference's. The other cases are the reference's own test bodies
(``tests/test_telemetry.py``) pointed at the port. Both tracers are
process-global: every test leaves them disabled.
"""
import json

import numpy as np
import pytest

import repro
import repro_torch
from repro import telemetry as ref_telemetry
from repro.algorithms import sources as ref_sources
from repro.core.program import clear_program_cache as ref_clear_program_cache
from repro.graph import generators as ref_generators
from repro_torch import telemetry
from repro_torch.algorithms import sources
from repro_torch.core.program import clear_program_cache
from repro_torch.graph import generators

LAUNCH_KEYS = ("kernel", "kind", "direction", "mode", "edges")


@pytest.fixture
def tracer():
    tr = telemetry.enable()
    tr.reset()
    yield tr
    telemetry.disable()


def _tree_names(tr, root_span):
    """All span names reachable from root_span (exclusive) via parent links."""
    by_parent = {}
    for s in tr.spans():
        by_parent.setdefault(s.parent_id, []).append(s)
    names, stack = [], [root_span.span_id]
    while stack:
        sid = stack.pop()
        for child in by_parent.get(sid, []):
            names.append(child.name)
            stack.append(child.span_id)
    return names


def _by_name(tr):
    out = {}
    for s in tr.spans():
        out.setdefault(s.name, []).append(s)
    return out


def _launches(tr):
    return [(s.name,) + tuple(s.attrs.get(k) for k in LAUNCH_KEYS)
            for s in tr.spans() if s.name.startswith("launch:")]


# --------------------------------------------------------------------------
# golden span tree, against the reference's
# --------------------------------------------------------------------------


def _golden_flow(pkg, src, g, clear, tr):
    clear()
    tr.reset()
    program = pkg.compile(src)
    kwargs = {"device": "cpu"} if pkg is repro_torch else {}
    acc = program.lower(pkg.Target(), shape=pkg.GraphShape.of(g), **kwargs)
    return acc.bind(g).run(root=3)


@pytest.fixture(scope="module")
def golden():
    """Both packages' flows, each under its own tracer: (result, spans)."""
    g = ref_generators.power_law(300, 2400, seed=2)
    tg = repro_torch.graph_from_arrays(g.n_vertices, g.src, g.dst,
                                       n_vertices_logical=g.n_vertices_logical,
                                       n_edges_logical=g.n_edges_logical)
    out = {}
    for name, pkg, tel, src, graph, clear in (
            ("reference", repro, ref_telemetry, ref_sources.BFS_ECP, g, ref_clear_program_cache),
            ("port", repro_torch, telemetry, sources.BFS_ECP, tg, clear_program_cache)):
        tr = tel.enable()
        try:
            result = _golden_flow(pkg, src, graph, clear, tr)
            out[name] = (result, tr.spans(), _launches(tr), _by_name(tr))
        finally:
            tel.disable()
    out["graph"] = g
    return out


def test_golden_span_tree_launch_list_equals_the_reference(golden):
    (_, _, want, _), (_, _, got, _) = golden["reference"], golden["port"]
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"launch span {i}: port {a} != reference {b}"
    assert {x[4] for x in got} == {"full", "compacted"}  # both launch modes occur


def test_golden_span_tree_shape(golden):
    result, spans, launches, by_name = golden["port"]
    for name in ("compile", "lower", "bind", "run"):
        assert len(by_name[name]) == 1, name
    assert len(launches) == result.stats.total_launches
    run_span = by_name["run"][0]
    by_parent = {}
    for s in spans:
        by_parent.setdefault(s.parent_id, []).append(s)
    below, stack = [], [run_span.span_id]
    while stack:
        for child in by_parent.get(stack.pop(), []):
            below.append(child.name)
            stack.append(child.span_id)
    assert sum(n.startswith("launch:") for n in below) == len(launches)
    assert all(s.trace_id == run_span.trace_id for s in spans if s.name.startswith("launch:"))
    # typed attributes, as the reference's
    assert by_name["compile"][0].attrs["fingerprint"]
    assert by_name["compile"][0].attrs["cache_hit"] is False
    assert by_name["lower"][0].attrs["target"] == "local"
    assert by_name["bind"][0].attrs["n_vertices"] == golden["graph"].n_vertices
    assert run_span.attrs["launches"] == result.stats.total_launches
    assert run_span.attrs["compacted"] == result.stats.compacted_launches
    assert run_span.attrs["full"] == result.stats.full_launches
    assert result.trace is not None
    assert sum(agg["count"] for n, agg in result.trace["spans"].items()
               if n.startswith("launch:")) == result.stats.total_launches
    ref_run = golden["reference"][3]["run"][0]
    assert {k: run_span.attrs[k] for k in ("launches", "compacted", "full", "supersteps")} == \
        {k: ref_run.attrs[k] for k in ("launches", "compacted", "full", "supersteps")}


# --------------------------------------------------------------------------
# enable/disable round trip
# --------------------------------------------------------------------------


def test_disable_retains_zero_spans():
    tr = telemetry.enable()
    tr.reset()
    g = generators.power_law(200, 1200, seed=0)
    repro_torch.compile(sources.BFS_ECP).bind(g, device="cpu").run(root=0)
    assert tr.spans()

    telemetry.disable()
    assert telemetry.get().spans() == []
    assert not telemetry.enabled()
    # the old tracer object was drained too (no hidden retention)
    assert tr.spans() == []

    # instrumented paths still run (as no-ops) while disabled
    result = repro_torch.compile(sources.BFS_ECP).bind(g, device="cpu").run(root=1)
    assert telemetry.get().spans() == []
    assert result.trace is None

    # re-enable starts clean
    tr2 = telemetry.enable()
    try:
        assert tr2.spans() == []
        r2 = repro_torch.compile(sources.BFS_ECP).bind(g, device="cpu").run(root=2)
        assert r2.trace is not None
        assert any(s.name == "run" for s in tr2.spans())
    finally:
        telemetry.disable()


def test_null_tracer_api_is_complete(tmp_path):
    telemetry.disable()
    tr = telemetry.get()
    assert not tr.enabled
    with tr.span("anything", attr=1) as sp:
        sp.set(more=2)
    assert tr.current() is None
    assert tr.spans() == []
    assert tr.summarize()["span_count"] == 0
    out = tmp_path / "empty.json"
    assert tr.export_chrome(str(out)) == 0
    doc = json.loads(out.read_text())
    assert doc["traceEvents"] == []
    assert tr.prometheus_text() == ""


# --------------------------------------------------------------------------
# exporters
# --------------------------------------------------------------------------


def test_chrome_export_valid_trace_event_json(tracer, tmp_path):
    g = generators.power_law(200, 1200, seed=1)
    repro_torch.compile(sources.BFS_ECP).bind(g, device="cpu").run(root=0)
    path = tmp_path / "trace.json"
    n = tracer.export_chrome(str(path))
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    complete = [e for e in events if e["ph"] == "X"]
    assert len(complete) == n == len(tracer.spans())
    for e in complete:
        assert e["ts"] >= 0 and e["dur"] >= 0
        assert isinstance(e["pid"], int) and isinstance(e["tid"], int)
        assert "span_id" in e["args"] and "trace_id" in e["args"]
    assert any(e["ph"] == "M" and e["name"] == "thread_name" for e in events)


def test_prometheus_exposition(tracer):
    g = generators.power_law(200, 1200, seed=1)
    repro_torch.compile(sources.BFS_ECP).bind(g, device="cpu").run(root=0)
    text = tracer.prometheus_text()
    assert 'repro_span_count{span="run"} 1' in text
    assert 'repro_span_duration_seconds_sum{span="run"}' in text
    assert 'quantile="0.99"' in text


# --------------------------------------------------------------------------
# profile persistence
# --------------------------------------------------------------------------


def test_profile_persists_with_artifact(tracer, tmp_path):
    clear_program_cache()
    g = generators.power_law(300, 2400, seed=3)
    program = repro_torch.compile(sources.BFS_ECP)
    acc = program.lower(repro_torch.Target(), shape=repro_torch.GraphShape.of(g), device="cpu")
    session = acc.bind(g)
    session.run(root=1)
    session.run(root=2)

    prof = acc.report().profile
    assert prof["runs"] == 2
    assert any(name.startswith("launch:") for name in prof["spans"])
    for agg in prof["spans"].values():
        assert agg["count"] > 0 and agg["total_s"] >= 0

    acc.save(str(tmp_path / "bfs"))
    loaded = repro_torch.load_accelerator(str(tmp_path / "bfs"), device="cpu")
    inherited = loaded.report().profile
    assert inherited["runs"] == 2
    assert inherited["spans"].keys() == prof["spans"].keys()
    # warm runs keep accumulating on top of the inherited baseline
    loaded.bind(g).run(root=3)
    assert loaded.report().profile["runs"] == 3
    assert "traced run(s)" in loaded.report().describe()


def test_result_trace_none_when_untraced():
    telemetry.disable()
    g = generators.power_law(200, 1200, seed=0)
    result = repro_torch.compile(sources.BFS_ECP).bind(g, device="cpu").run(root=0)
    assert result.trace is None


@pytest.mark.parametrize("msbfs", [True, False])
def test_batched_runs_share_one_trace_summary(tracer, msbfs):
    g = generators.power_law(300, 2400, seed=4)
    batch = repro_torch.compile(sources.BFS_ECP).bind_batch(g, device="cpu", msbfs=msbfs)
    results = batch.run_many([{"root": int(r)} for r in np.arange(4)])
    traces = {id(r.trace) for r in results}
    assert len(traces) == 1
    trace = results[0].trace
    assert trace["span_count"] >= 1
    run_spans = [s for s in tracer.spans() if s.name == "run"]
    assert any(s.attrs.get("batch_size", 0) >= 1 for s in run_spans)
    assert run_spans[-1].attrs["msbfs"] is msbfs
    launches = [s for s in tracer.spans() if s.name.startswith("launch:")]
    # MS-BFS's packed steps are one launch key of their own, not a kernel
    st = results[0].stats
    assert len(launches) == st.total_launches - st.kernel_launches.get("__msbfs__", 0)
    assert all(s.attrs["mode"] == "batched" and s.attrs["batch_size"] == 4 for s in launches)


def test_accelerator_batch_session_feeds_the_profile(tracer):
    g = generators.power_law(300, 2400, seed=4)
    acc = repro_torch.compile(sources.SSSP).lower(graph=g.with_unit_weights(), device="cpu")
    results = acc.bind_batch(g.with_unit_weights()).run_many([{"root": r} for r in range(3)])
    assert acc.report().profile["runs"] == 1
    assert results[0].trace["spans"]["run"]["count"] == 1


# --------------------------------------------------------------------------
# head-based trace sampling
# --------------------------------------------------------------------------


def test_sample_zero_drops_whole_traces():
    tr = telemetry.tracer.Tracer(sample=0.0)
    with tr.span("root") as root:
        assert root.context() is None
        assert tr.current() is None
        with tr.span("child") as child:
            assert child is telemetry.NULL_SPAN
            with tr.span("grandchild"):
                pass
    assert tr.spans() == []
    assert tr.sampled_out == 1
    assert tr.summarize()["span_count"] == 0


def test_sample_one_keeps_everything():
    tr = telemetry.tracer.Tracer(sample=1.0)
    for _ in range(20):
        with tr.span("root"):
            with tr.span("child"):
                pass
    assert len(tr.spans()) == 40
    assert tr.sampled_out == 0


def test_sampling_is_per_root_and_seed_deterministic():
    def kept_roots(seed):
        tr = telemetry.tracer.Tracer(sample=0.5, seed=seed)
        for i in range(200):
            with tr.span("root", i=i):
                with tr.span("child"):
                    pass
        kept = sorted(s.attrs["i"] for s in tr.spans() if s.name == "root")
        n_roots = len(kept)
        assert len(tr.spans()) == 2 * n_roots
        assert tr.sampled_out == 200 - n_roots
        return kept

    a, b = kept_roots(seed=7), kept_roots(seed=7)
    assert a == b
    assert 0 < len(a) < 200
    assert kept_roots(seed=8) != a


def test_explicit_parent_bypasses_sampling():
    tr = telemetry.tracer.Tracer(sample=0.0)
    ctx = telemetry.tracer.SpanContext(trace_id=42, span_id=42)
    with tr.span("handed-off", parent=ctx) as sp:
        assert sp is not telemetry.NULL_SPAN
    assert [s.name for s in tr.spans()] == ["handed-off"]
    assert tr.spans()[0].trace_id == 42


def test_record_span_respects_sampling():
    tr = telemetry.tracer.Tracer(sample=0.0)
    sp = tr.record_span("queue_wait", 0.0, 1.0)
    assert sp is not None
    assert tr.spans() == []
    assert tr.sampled_out == 1


def test_reset_zeroes_sampled_out_counter():
    tr = telemetry.tracer.Tracer(sample=0.0)
    with tr.span("root"):
        pass
    assert tr.sampled_out == 1
    tr.reset()
    assert tr.sampled_out == 0


def test_enable_sample_validates_and_updates_in_place():
    tr = telemetry.enable(sample=0.25, seed=3)
    try:
        assert tr.sample == 0.25
        same = telemetry.enable(sample=1.0)
        assert same is tr
        assert tr.sample == 1.0
        telemetry.enable()
        assert tr.sample == 1.0
        with pytest.raises(ValueError):
            telemetry.enable(sample=1.5)
        with pytest.raises(ValueError):
            telemetry.tracer.Tracer(sample=-0.1)
    finally:
        telemetry.disable()


def test_sampled_trace_still_counts_engine_runs(tracer):
    # sampling drops telemetry, never work
    telemetry.enable(sample=0.0)
    g = generators.chain(64)
    acc = repro_torch.compile(sources.BFS_ECP).lower(graph=g, device="cpu")
    session = acc.bind(g)
    try:
        res = session.run(root=0)
    finally:
        session.close()
    assert (np.asarray(res.properties["old_level"]) >= 0).sum() == 64
    assert res.trace is None
    assert tracer.sampled_out >= 1
    assert tracer.spans() == []


def test_histogram_percentiles_match_the_reference():
    from repro.serving.metrics import LatencyHistogram as RefHistogram
    from repro_torch.telemetry.histogram import LatencyHistogram

    ours, theirs = LatencyHistogram(), RefHistogram()
    for x in np.random.default_rng(0).lognormal(-6, 2, 500):
        ours.record(x)
        theirs.record(x)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.merge(LatencyHistogram()).counts == theirs.counts
