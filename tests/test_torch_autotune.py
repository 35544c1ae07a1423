"""The port's autotuner held to the reference's.

* The analysis-pruned candidate grid and its prune notes equal the
  reference's for all eight programs (and a racy one): the port's Target
  lacks the reference's routing fields, so the grid is compared on the
  four searched knobs.
* The TuningCache round-trips configs through per-key JSON files of the
  port's own ``Target.to_dict()``, treats corrupt or foreign files as
  misses, and a fresh cache over the same store answers with zero trials.
* ``lower(tuned=True)`` is a lookup that stamps the manifest; the serving
  tier resolves tuned Targets (``tuned_hits``) and answers as the base
  target does, bit for bit.
* The tuner, the offline CLI and the report's ``None`` byte estimates run
  on the CPU here (``device="cpu"``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from dataclasses import fields
from pathlib import Path

import numpy as np
import pytest

import repro
import repro_torch
from repro import autotune as ref_autotune
from repro.algorithms import sources as ref_sources
from repro_torch import CompileOptions, Target, generators
from repro_torch.algorithms import embedded, sources
from repro_torch.autotune import (
    SEARCHED_KNOBS,
    AutoTuner,
    TunedConfig,
    TuningCache,
    autotune,
    program_mir_fingerprint,
    shape_bucket,
    tuning_dir_for,
    tuning_key,
)
from repro_torch.core.accelerator import GraphShape, accelerator_fingerprint, load_accelerator

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


@pytest.fixture
def graph():
    return generators.power_law(400, 2400, seed=0)


@pytest.fixture
def bfs_program():
    return repro_torch.compile(sources.BFS_ECP)


def _knobs(targets):
    return [tuple(getattr(t, k) for k in SEARCHED_KNOBS) for t in targets]


# --------------------------------------------------------------------------
# the candidate grid
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", PROGRAMS + ["RACY"])
def test_candidate_grid_and_prune_notes_match_the_reference(name):
    src = RACY_GT if name == "RACY" else getattr(sources, name)
    ours = repro_torch.compile(src)
    theirs = repro.compile(RACY_GT if name == "RACY" else getattr(ref_sources, name))
    got, got_notes = AutoTuner(TuningCache()).candidates(ours, Target())
    want, want_notes = ref_autotune.AutoTuner(ref_autotune.TuningCache()).candidates(
        theirs, theirs.options.resolve_target())
    assert _knobs(got) == _knobs(want)
    assert got_notes == want_notes
    assert len(set(got)) == len(got)
    # every field outside the searched knobs stays the base target's
    rest = [f.name for f in fields(Target) if f.name not in SEARCHED_KNOBS]
    assert all(getattr(t, f) == getattr(Target(), f) for t in got for f in rest)
    if name == "RACY":
        assert all(t.shuffle for t in got) and len(got) < 16


def test_searched_knobs_are_the_references():
    assert SEARCHED_KNOBS == ref_autotune.SEARCHED_KNOBS
    assert repro_torch.autotune.OBJECTIVE == ref_autotune.OBJECTIVE


def test_keys_match_the_reference(graph):
    ref_graph = repro.graph.generators.power_law(400, 2400, seed=0)
    for name in PROGRAMS:
        assert program_mir_fingerprint(repro_torch.compile(getattr(sources, name))) == \
            ref_autotune.program_mir_fingerprint(repro.compile(getattr(ref_sources, name)))
    ours, theirs = shape_bucket(graph=graph), ref_autotune.shape_bucket(graph=ref_graph)
    assert (ours.n_vertices, ours.n_edges, ours.weighted) == \
        (theirs.n_vertices, theirs.n_edges, theirs.weighted)


# --------------------------------------------------------------------------
# TuningCache persistence
# --------------------------------------------------------------------------


def _mk_config(mir_fp="a" * 64, target=None, bucket=None) -> TunedConfig:
    return TunedConfig(
        mir_fingerprint=mir_fp,
        bucket=bucket or GraphShape.bucket_for(400, 2400, weighted=False),
        target=target or Target(), objective_s=0.010, baseline_s=0.025, trials=5,
    )


def test_cache_memory_roundtrip():
    cache = TuningCache()
    cfg = _mk_config()
    cache.put(cfg)
    assert cache.get(cfg.mir_fingerprint, cfg.bucket, cfg.target.kind) == cfg
    assert cache.stats()["hits"] == 1
    assert cache.get("b" * 64, cfg.bucket) is None
    assert cache.stats()["misses"] == 1


def test_cache_disk_roundtrip_fresh_instance(tmp_path):
    store = str(tmp_path / "tuning")
    cfg = _mk_config(target=Target(burst=False, compact_frontier=False))
    TuningCache(store).put(cfg)
    fresh = TuningCache(store)
    got = fresh.get(cfg.mir_fingerprint, cfg.bucket, cfg.target.kind)
    assert got == cfg and got.target is not cfg.target
    assert fresh.stats() == {"entries": 1, "hits": 1, "misses": 0, "stores": 0}
    with open(fresh._path(cfg.key)) as f:
        on_disk = json.load(f)
    assert on_disk["target"] == cfg.target.to_dict()  # the port's own fields


def test_cache_corrupt_file_is_a_miss_not_a_crash(tmp_path):
    store = str(tmp_path / "tuning")
    cfg = _mk_config()
    cache = TuningCache(store)
    cache.put(cfg)
    with open(cache._path(cfg.key), "w") as f:
        f.write("{not json")
    fresh = TuningCache(store)
    assert fresh.get(cfg.mir_fingerprint, cfg.bucket, cfg.target.kind) is None
    fresh.put(cfg)
    assert TuningCache(store).get(cfg.mir_fingerprint, cfg.bucket, cfg.target.kind) == cfg


def test_cache_foreign_and_reference_files_are_misses(tmp_path):
    store = str(tmp_path / "tuning")
    cfg = _mk_config()
    cache = TuningCache(store)
    cache.put(cfg)
    other_key = tuning_key("c" * 64, cfg.bucket, cfg.target.kind)
    os.replace(cache._path(cfg.key), cache._path(other_key))
    assert TuningCache(store).get("c" * 64, cfg.bucket, cfg.target.kind) is None
    # a reference-package file at the port's key: its Target has fields the
    # port's lacks, so it is a miss, never a crash
    ref_cfg = ref_autotune.TunedConfig(
        mir_fingerprint="d" * 64,
        bucket=repro.core.accelerator.GraphShape.bucket_for(400, 2400),
        target=repro.Target(), objective_s=0.01, baseline_s=0.02, trials=2)
    path = cache._path(tuning_key("d" * 64, cfg.bucket))
    with open(path, "w") as f:
        json.dump(ref_cfg.to_dict(), f)
    assert TuningCache(store).get("d" * 64, cfg.bucket) is None


def test_tuned_config_dict_roundtrip_preserves_target_identity():
    cfg = _mk_config(target=Target(burst=False, shuffle=False))
    back = TunedConfig.from_dict(json.loads(json.dumps(cfg.to_dict())))
    assert back == cfg and back.target == cfg.target
    assert hash(back.target) == hash(cfg.target) and back.key == cfg.key
    shape = GraphShape(n_vertices=512, n_edges=4096, weighted=False)
    assert accelerator_fingerprint("f" * 64, back.target, shape) == \
        accelerator_fingerprint("f" * 64, cfg.target, shape)
    assert "tuned[" in back.describe() and back.speedup == pytest.approx(2.5)


def test_mir_fingerprint_is_front_end_independent():
    """The key is the optimized MIR's hash: the twins of one program share
    it under each pass pipeline (the port's options all change the MIR, so
    there is no options-only change to be independent of)."""
    for passes in ("default", "none"):
        opts = CompileOptions(passes=passes)
        text = repro_torch.compile(sources.BFS_ECP, opts)
        twin = repro_torch.compile(embedded.BFS_ECP_EMBEDDED, opts)
        assert program_mir_fingerprint(text) == program_mir_fingerprint(twin)
        assert program_mir_fingerprint(text) == repro_torch.core.mir.fingerprint(text.module)


def test_shape_bucket_is_padding_invariant(graph):
    bucket = shape_bucket(graph=graph)
    assert shape_bucket(graph=graph.pad_to(bucket.n_vertices, bucket.n_edges)) == bucket
    with pytest.raises(ValueError):
        shape_bucket()


# --------------------------------------------------------------------------
# the search end to end (on the CPU)
# --------------------------------------------------------------------------


def test_tune_searches_then_fresh_cache_reuses_with_zero_trials(bfs_program, graph, tmp_path):
    store = tuning_dir_for(str(tmp_path))
    tuner = AutoTuner(TuningCache(store), reps=1, max_candidates=3, device="cpu")
    report = tuner.tune(bfs_program, graph, params={"root": 0})
    assert not report.cache_hit and report.trials >= 2
    assert report.candidates == 16 and report.pruned == ()
    assert report.config.objective_s > 0
    assert report.config.objective_s <= report.config.baseline_s * 1.0001
    assert report.accelerator is not None
    assert report.accelerator.tuned == report.config.to_dict()
    assert report.accelerator.device == "cpu"
    assert sum(m["winner"] for m in report.measurements) >= 1
    assert "measured trial" in report.describe()
    assert not repro_torch.telemetry.enabled()  # the search restores tracing

    fresh = AutoTuner(TuningCache(store), device="cpu")
    warm = fresh.tune(bfs_program, graph, params={"root": 0})
    assert warm.cache_hit and warm.trials == 0 and warm.config == report.config
    assert fresh.cache.hits >= 1
    # the twin shares the tuned config: one MIR, one key
    assert fresh.tune(repro_torch.compile(embedded.BFS_ECP_EMBEDDED), graph,
                      params={"root": 0}).cache_hit


def test_autotune_convenience_and_force(bfs_program, graph, tmp_path):
    cache = TuningCache(tuning_dir_for(str(tmp_path)))
    first = autotune(bfs_program, graph, params={"root": 0}, cache=cache, reps=1,
                     max_candidates=2, device="cpu")
    again = autotune(bfs_program, graph, params={"root": 0}, cache=cache, device="cpu")
    assert again.cache_hit and again.trials == 0
    forced = autotune(bfs_program, graph, params={"root": 0}, cache=cache, reps=1,
                      max_candidates=2, force=True, device="cpu")
    assert not forced.cache_hit and forced.trials >= 2
    assert first.config.key == forced.config.key


def test_lower_tuned_true_is_pure_lookup_and_stamps_manifest(bfs_program, graph, tmp_path):
    cache = TuningCache(tuning_dir_for(str(tmp_path)))
    tuned_target = Target(cache=False, shuffle=False)
    cache.put(TunedConfig(
        mir_fingerprint=program_mir_fingerprint(bfs_program),
        bucket=shape_bucket(graph=graph), target=tuned_target,
        objective_s=0.001, baseline_s=0.002, trials=3,
    ))
    acc = bfs_program.lower(graph=graph, tuned=True, tuning_cache=cache, device="cpu")
    assert acc.target == tuned_target and acc.tuned is not None
    assert Target.from_dict(acc.tuned["target"]) == tuned_target
    other = generators.power_law(5000, 60000, seed=1)
    acc_miss = bfs_program.lower(graph=other, tuned=True, tuning_cache=cache, device="cpu")
    assert acc_miss.tuned is None and acc_miss.target == Target()
    art = acc.save(str(tmp_path / "art"))
    with open(os.path.join(art, "manifest.json")) as f:
        assert json.load(f)["tuned"] == acc.tuned
    loaded = load_accelerator(art, device="cpu")
    assert loaded.tuned == acc.tuned and loaded.target == tuned_target
    # a tuned lowering answers as the base target's does
    np.testing.assert_array_equal(
        loaded.bind(graph).run(root=3).properties["old_level"],
        bfs_program.bind(graph, device="cpu").run(root=3).properties["old_level"])


@pytest.mark.parametrize("name,params", [("bfs", [{"root": r} for r in range(5)]),
                                         ("sssp", [{"root": r} for r in (0, 3, 8)])])
def test_serving_resolves_tuned_target_and_answers_as_the_base(name, params, tmp_path):
    from repro_torch.serving import NAMED_ALGORITHMS

    g = generators.power_law(400, 2400, seed=0, weighted=(name == "sssp"))
    program = repro_torch.compile(NAMED_ALGORITHMS[name])
    store = str(tmp_path / "registry")
    tuned_target = Target(shuffle=False, compact_frontier=False, cache=False)
    TuningCache(tuning_dir_for(store)).put(TunedConfig(
        mir_fingerprint=program_mir_fingerprint(program), bucket=shape_bucket(graph=g),
        target=tuned_target, objective_s=0.001, baseline_s=0.002, trials=3,
    ))
    with repro_torch.serve(store, workers=1, max_batch=4, device="cpu") as svc:
        futs = [svc.submit(name, g, **p) for p in params]
        tuned = [f.result(timeout=120) for f in futs]
        snap = svc.stats()
        (entry,) = svc.registry._residents.values()
        assert entry.accelerator.target == tuned_target
    with repro_torch.serve(store, workers=1, max_batch=4, autotune=False,
                           device="cpu") as base:
        plain = [base.submit(name, g, **p).result(timeout=120) for p in params]
        assert base.stats()["queries"]["tuned_hits"] == 0
        assert base.stats()["tuning"]["enabled"] is False
    assert snap["programs"][name]["tuned_hits"] == len(params)
    assert snap["queries"]["tuned_hits"] == len(params)
    assert snap["tuning"]["hits"] == len(params) and snap["tuning"]["enabled"] is True
    for a, b in zip(tuned, plain):
        for prop, x in b.properties.items():
            np.testing.assert_array_equal(a.properties[prop], x, err_msg=prop)


def test_serving_pinned_target_wins_over_tuning(bfs_program, graph, tmp_path):
    store = str(tmp_path / "registry")
    TuningCache(tuning_dir_for(store)).put(TunedConfig(
        mir_fingerprint=program_mir_fingerprint(bfs_program), bucket=shape_bucket(graph=graph),
        target=Target(shuffle=False), objective_s=0.001, baseline_s=0.002, trials=3,
    ))
    with repro_torch.serve(store, workers=1, target=Target(), device="cpu") as svc:
        svc.run(bfs_program, graph, root=0)
        assert svc.stats()["queries"]["tuned_hits"] == 0


# --------------------------------------------------------------------------
# the report's missing estimates and the tuner's fallbacks
# --------------------------------------------------------------------------


def test_report_has_no_byte_estimates_and_the_cost_model_copes(bfs_program, graph):
    rep = bfs_program.lower(graph=graph, device="cpu").report()
    assert rep.kernels
    assert all((k.flops or 0) > 0 for k in rep.kernels)
    assert all(k.bytes_accessed is None for k in rep.kernels)
    scores = [AutoTuner._cost_score(t, rep.kernels)
              for t in AutoTuner(TuningCache()).candidates(bfs_program, Target())[0]]
    assert min(scores) > 0 and len(set(scores)) > 1

    class Plan:
        kind = "edge"
        direction = "auto"
        flops = None
        bytes_accessed = None

    assert AutoTuner._cost_score(Target(), [Plan()]) > 0


def test_objective_falls_back_to_wall_time():
    assert AutoTuner._objective_from_trace(None, 0.5) == 0.5
    assert AutoTuner._objective_from_trace({"spans": {}}, 0.5) == 0.5
    trace = {"spans": {"launch:k": {"total_s": 0.2}, "run": {"total_s": 9.0}}}
    assert AutoTuner._objective_from_trace(trace, 0.5) == pytest.approx(0.2)


def test_tuner_parameter_validation():
    with pytest.raises(ValueError):
        AutoTuner(TuningCache(), reps=0)
    with pytest.raises(ValueError):
        AutoTuner(TuningCache(), margin=1.0)
    with pytest.raises(ValueError):
        AutoTuner(TuningCache(), max_candidates=0)


def test_offline_cli_searches_then_hits(tmp_path):
    args = [sys.executable, "-m", "repro_torch.autotune", "--algo", "bfs", "--vertices", "300",
            "--edges", "1800", "--param", "root=0", "--store", str(tmp_path), "--reps", "1",
            "--max-candidates", "2", "--device", "cpu", "--json"]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    first = subprocess.run(args, capture_output=True, text=True, env=env, timeout=300)
    assert first.returncode == 0, first.stderr[-3000:]
    doc = json.loads(first.stdout)
    assert not doc["cache_hit"] and doc["trials"] >= 2
    assert doc["store"] == os.path.join(str(tmp_path), "tuning")
    again = subprocess.run(args, capture_output=True, text=True, env=env, timeout=300)
    assert again.returncode == 0, again.stderr[-3000:]
    doc2 = json.loads(again.stdout)
    assert doc2["cache_hit"] and doc2["trials"] == 0
    assert doc2["config"] == doc["config"]
