"""Serving driver: LM decode serving and graph-query serving.

LM path — step-wise prefill + decode with a KV cache. On a CUDA device
every attention runs through the hand-written flash kernel and every MoE
dispatch through the hand-written gather kernel:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b

``--smoke`` takes the reduced same-family config in float32 (the full
config runs in bfloat16, as the reference runs it); ``--device cpu`` runs
the plain PyTorch versions of the kernels on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b --smoke \\
        --device cpu

Graph path — a thin client over the serving tier: ``repro_torch.serve()``
stands up a :class:`~repro_torch.serving.GraphService` (artifact registry
+ async scheduler + metrics) and this driver submits parameterized
queries to it:

    PYTHONPATH=src python -m repro_torch.launch.serve --graph bfs \\
        --queries 32 --pool 4

``--batch N`` turns on dynamic batching: queued queries are collected into
batches of up to N and answered by one batched execution (bit-identical
results, far fewer launches). Stats are the service's JSON metrics
snapshot (per-tenant counters, latency percentiles, registry hits, batch
occupancy) printed verbatim.

``--updates N`` switches the graph path to streaming serving: N
edge-addition deltas are interleaved through the query stream via a
StreamingSession — in-place updates into the padding slack (no
re-lowering), incremental repair for monotone programs — and per-version
query latency plus update-apply latency are reported.

``--autotune`` runs the :mod:`repro_torch.autotune` search for the served
(program, graph bucket) before the service starts; the winning Target
persists in the TuningCache next to the artifact store, so this process
and every later one resolve it by lookup (``tuned_hits`` in the stats
snapshot) — a second ``--autotune`` start performs zero search trials.

``--artifact-dir DIR`` overrides the service's artifact registry location
(default: ``$REPRO_TORCH_ARTIFACT_DIR`` / ``~/.cache/repro-torch-artifacts``):
the program is lowered once per (program, target, shape bucket) into a
saved :class:`~repro_torch.core.accelerator.Accelerator` artifact, and
every later process start loads it. The stats snapshot reports resident
hits vs artifact hits vs cold lowerings.

Without ``--device`` every path needs a GPU and raises without one;
``--device cpu`` runs the plain versions of the kernels on the CPU.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, smoke_config
from ..core.session import resolve_device
from ..models import Model


@torch.no_grad()
def generate(model: Model, prompts: torch.Tensor, gen_len: int, greedy: bool = True,
             seed: int = 0, step_s: Optional[List[float]] = None) -> torch.Tensor:
    """Prefill via step-wise cache fill, then decode ``gen_len`` tokens.

    ``prompts [B, P]`` (int64 on the model's device) -> ``[B, gen_len]``.
    Greedy takes the first maximum, as ``argmax`` does; sampling draws from
    a ``torch.Generator`` seeded with ``seed``. A list passed as ``step_s``
    receives the seconds of every decode step, each ended by a device
    synchronise (only then does a step wait for the card).
    """
    b, plen = prompts.shape
    cache = model.init_cache(b, plen + gen_len)
    gen = torch.Generator(device=prompts.device).manual_seed(seed)

    def step(tok):
        nonlocal cache
        t0 = time.perf_counter()
        logits, cache = model.decode_step(cache, tok)
        if step_s is not None:
            if prompts.is_cuda:
                torch.cuda.synchronize(prompts.device)
            step_s.append(time.perf_counter() - t0)
        return logits

    logits = None
    for t in range(plen):  # prefill (teacher forcing the prompt)
        logits = step(prompts[:, t:t + 1])
    out = []
    for _ in range(gen_len):
        last = logits[:, -1]
        if greedy:
            tok = torch.argmax(last, dim=-1, keepdim=True)
        else:
            tok = torch.multinomial(torch.softmax(last.float(), dim=-1), 1, generator=gen)
        out.append(tok)
        logits = step(tok)
    return torch.cat(out, dim=1)


GRAPH_ALGOS = ("bfs", "pagerank", "sssp")


def _export_trace(trace_dir: str) -> None:
    """Dump the session's telemetry: Chrome trace + per-request spans.

    Writes ``trace.json`` (chrome://tracing / Perfetto ``trace_event``
    format) and ``requests.jsonl`` (one line per request trace: the
    span tree flattened with durations and attributes), then prints the
    queue-wait vs execution latency split from the span histograms.
    """
    import json
    import os

    from .. import telemetry as tel

    tr = tel.get()
    os.makedirs(trace_dir, exist_ok=True)
    chrome = os.path.join(trace_dir, "trace.json")
    n = tr.export_chrome(chrome)
    by_trace: dict = {}
    for s in tr.spans():
        by_trace.setdefault(s.trace_id, []).append(s)
    req_path = os.path.join(trace_dir, "requests.jsonl")
    with open(req_path, "w") as f:
        for trace_id in sorted(by_trace):
            spans = sorted(by_trace[trace_id], key=lambda s: s.t_start)
            f.write(json.dumps({
                "trace_id": trace_id,
                "spans": [
                    {
                        "name": s.name,
                        "span_id": s.span_id,
                        "parent_id": s.parent_id,
                        "duration_ms": round((s.t_end - s.t_start) * 1e3, 3),
                        "attrs": dict(s.attrs),
                    }
                    for s in spans
                ],
            }) + "\n")
    hists = tr.histograms()
    qw, ex = hists.get("queue_wait"), hists.get("execute")
    if qw is not None and ex is not None and qw.total and ex.total:
        print(f"latency split: queue-wait p50={qw.percentile(50) * 1e3:.2f}ms "
              f"(total {qw.sum_s * 1e3:.1f}ms) vs execution "
              f"p50={ex.percentile(50) * 1e3:.2f}ms "
              f"(total {ex.sum_s * 1e3:.1f}ms) over {ex.total} request(s)")
    print(f"trace: {n} span(s) -> {chrome}; per-request dumps -> {req_path}")


def resolve_accelerator(program, graph, backend: str, artifact_dir: str,
                        verbose: bool = True, device: Optional[str] = None):
    """Load-or-lower the Accelerator for (program, backend, graph shape) on
    ``device``.

    Thin reporting wrapper over
    :func:`repro_torch.core.accelerator.load_or_lower`: artifacts are keyed by
    the accelerator fingerprint (program content hash + target + shape),
    so a stale or foreign artifact is never picked up, and an unwritable
    store degrades to cold lowering instead of failing the server.
    """
    from ..core.accelerator import GraphShape, load_or_lower
    from ..core.target import Target

    target = Target(kind=backend)
    acc, loaded, dt = load_or_lower(
        program, target, GraphShape.of(graph), artifact_dir, device=device
    )
    if verbose:
        how = "warm start: loaded" if loaded else "cold start: lowered"
        print(f"{how} accelerator {acc.fingerprint[:12]} in {dt:.3f}s "
              f"(store: {artifact_dir})")
    return acc


def serve_graph(args) -> int:
    """Serve a batch of graph queries through :func:`repro_torch.serve`.

    Thin client over the serving tier: one ``repro_torch.serve(registry_dir)``
    call stands up the :class:`~repro_torch.serving.GraphService` (artifact
    registry with resident/warm/cold selection, async scheduler with
    dynamic batching, metrics), and this driver only generates queries,
    submits them, and prints ``service.stats()`` — the JSON snapshot is
    the stats output, not hand-rolled counters.
    """
    import json

    from .. import telemetry as tel
    from ..graph import generators
    from ..serving import serve

    if args.trace_dir:
        tel.enable()

    result_prop = {"bfs": "old_level", "pagerank": "rank", "sssp": "SP"}[args.graph]
    weighted = args.graph == "sssp"
    graph = generators.power_law(
        args.vertices, args.edges, seed=args.seed, weighted=weighted
    )
    rng = np.random.default_rng(args.seed)
    if args.graph == "pagerank":
        queries = [{"iters": int(i)} for i in rng.integers(5, 25, args.queries)]
    else:
        roots = rng.integers(0, graph.n_vertices, args.queries)
        queries = [{"root": int(r)} for r in roots]

    max_batch = args.batch if args.batch and args.batch > 1 else 1
    mode = f"dynamic batching x{max_batch}" if max_batch > 1 else "per-query"
    registry_dir = args.artifact_dir if args.artifact_dir else None

    if args.autotune:
        # search BEFORE the service starts, against the same TuningCache
        # the service resolves from — every submission below then picks
        # the tuned Target via pure lookup (tuned_hits in the snapshot)
        from ..autotune import AutoTuner, TuningCache, tuning_dir_for
        from ..core.program import compile_program
        from ..serving.registry import default_artifact_dir
        from ..serving.service import NAMED_ALGORITHMS

        store = registry_dir if registry_dir else default_artifact_dir()
        tuner = AutoTuner(TuningCache(tuning_dir_for(store)), reps=2,
                          max_candidates=8, device=args.device)
        report = tuner.tune(
            compile_program(NAMED_ALGORITHMS[args.graph]), graph,
            params=queries[0],
        )
        how = ("cache hit, zero trials" if report.cache_hit
               else f"{report.trials} trial(s)")
        print(f"autotune: {report.config.target.describe()} "
              f"({how}, {report.config.speedup:.2f}x over baseline)")
    print(f"serving {args.queries} {args.graph} queries on |V|={graph.n_vertices} "
          f"|E|={graph.n_edges} via repro_torch.serve ({args.pool} workers, "
          f"{args.backend} backend on {args.device or 'cuda'}, {mode})")
    with serve(registry_dir, backend=args.backend, workers=args.pool,
               max_batch=max_batch, device=args.device) as service:
        t_warm = time.perf_counter()
        # first query resolves resident/warm-artifact/cold-compile
        first = service.run(args.graph, graph, **queries[0])
        warm_s = time.perf_counter() - t_warm
        t0 = time.perf_counter()
        futures = [service.submit(args.graph, graph, **q) for q in queries]
        results = [f.result() for f in futures]
        dt = time.perf_counter() - t0
        stats = service.stats()
    assert len(results) == len(queries)
    sample = np.asarray(first.properties[result_prop])
    lat = stats["queries"]["latency_ms"]
    reg = stats["registry"]
    how = ("resident" if reg["resident_hits"] else
           "warm artifact" if reg["artifact_hits"] else "cold compile")
    print(f"answered {len(results)} queries in {dt:.3f}s "
          f"({len(results) / dt:.1f} qps)")
    print(f"latency per query: p50={lat['p50_ms']:.1f}ms "
          f"p90={lat['p90_ms']:.1f}ms p99={lat['p99_ms']:.1f}ms")
    print(f"first query start: {how} in {warm_s:.3f}s "
          f"(store: {reg['store_dir']})")
    b = stats["batches"]
    if b["batches"]:
        print(f"dynamic batching: {b['batches']} batches for {b['queries']} "
              f"queries, occupancy {b['occupancy']:.0%} of "
              f"max_batch={b['max_batch']}")
    rejected = stats["queries"]["rejections_analysis"]
    if rejected:
        print(f"admission control: {rejected} submission(s) rejected by "
              f"static analysis (see per-tenant rejections_analysis)")
    print(f"first result ({result_prop}): min={sample.min():.4g} "
          f"max={sample.max():.4g}")
    print("service stats snapshot:")
    print(json.dumps(stats, indent=2, sort_keys=True))
    if args.trace_dir:
        _export_trace(args.trace_dir)
    return 0


def serve_streaming(args) -> int:
    """``--updates N``: serve queries over a *mutating* graph.

    N additions-only deltas (each ~1% of |E| random edges) are interleaved
    evenly through the query stream via a
    :class:`~repro_torch.streaming.StreamingSession`. Every update is an in-place
    ``apply_updates`` into the graph's padding slack — a shape-check-only
    rebind, no re-lowering — and repeated queries are answered by
    incremental repair when the program is monotone (bfs/sssp) or a full
    re-run otherwise (pagerank). Reports per-version query latency and
    update-apply latency so the streaming cost model is observable.
    """
    from ..algorithms import sources
    from ..core.accelerator import GraphShape
    from ..core.program import compile_program
    from ..graph import generators
    from ..graph.storage import GraphDelta
    from ..streaming import StreamingSession

    from .. import telemetry as tel

    if args.trace_dir:
        tel.enable()
    src = {
        "bfs": sources.BFS_ECP,
        "pagerank": sources.PAGERANK,
        "sssp": sources.SSSP,
    }[args.graph]
    weighted = args.graph == "sssp"
    base = generators.power_law(
        args.vertices, args.edges, seed=args.seed, weighted=weighted
    )
    shape = GraphShape.bucket_for(
        base.n_vertices, base.n_edges, weighted=weighted
    )
    graph = base.pad_to(shape.n_vertices, shape.n_edges)
    program = compile_program(src)
    rng = np.random.default_rng(args.seed)
    if args.graph == "pagerank":
        queries = [{"iters": int(i)} for i in rng.integers(5, 25, args.queries)]
    else:
        # few distinct roots, repeated: repeats across versions are exactly
        # the queries incremental repair accelerates
        roots = rng.integers(0, base.n_vertices, max(4, args.queries // 4))
        queries = [{"root": int(roots[i % len(roots)])}
                   for i in range(args.queries)]

    accelerator = None
    if args.artifact_dir:
        accelerator = resolve_accelerator(
            program, graph, args.backend, args.artifact_dir, device=args.device
        )
    print(f"streaming-serving {args.queries} {args.graph} queries with "
          f"{args.updates} interleaved updates on |V|={base.n_vertices} "
          f"|E|={base.n_edges} (bucket {shape.n_vertices}x{shape.n_edges}, "
          f"{args.backend} backend)")

    n_add = max(1, base.n_edges // 100)  # ~1% of |E| per delta
    stride = max(1, args.queries // (args.updates + 1))
    lat_by_version: dict = {}
    with StreamingSession(
        program, graph, backend=args.backend, accelerator=accelerator,
        pool_size=args.pool, batch=args.batch, device=args.device,
    ) as ss:
        ss.warmup(**queries[0])
        t0 = time.perf_counter()
        for i, q in enumerate(queries):
            if args.updates and i and i % stride == 0 and ss.updates < args.updates:
                lv = ss.graph.n_vertices_logical
                edges = rng.integers(0, lv, size=(n_add, 2)).astype(np.int32)
                w = (rng.integers(1, 64, size=n_add).astype(np.float32)
                     if weighted else None)
                ss.update(GraphDelta(added_edges=edges, added_weights=w))
            t_q = time.perf_counter()
            result = ss.run(**q)
            lat_by_version.setdefault(result.version, []).append(
                (time.perf_counter() - t_q) * 1e3
            )
        dt = time.perf_counter() - t0
        print(f"answered {args.queries} queries across {ss.version + 1} graph "
              f"versions in {dt:.3f}s ({args.queries / dt:.1f} qps)")
        for version in sorted(lat_by_version):
            lat = np.asarray(lat_by_version[version])
            print(f"  version {version}: {len(lat)} queries, "
                  f"p50={np.percentile(lat, 50):.1f}ms "
                  f"max={lat.max():.1f}ms")
        if ss.update_apply_s:
            apply_ms = np.asarray(ss.update_apply_s) * 1e3
            print(f"updates: {ss.updates} applied ({n_add} edges each), "
                  f"apply p50={np.percentile(apply_ms, 50):.1f}ms "
                  f"max={apply_ms.max():.1f}ms, rebuckets={ss.rebuckets}")
        print(f"answer paths: {ss.cache_hits} cache hits, "
              f"{ss.incremental_runs} incremental repairs, "
              f"{ss.full_runs} full runs "
              f"(monotone={ss.incremental_info.monotone})")
    if args.trace_dir:
        _export_trace(args.trace_dir)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="LM decode serving and graph-query serving")
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config, in float32")
    ap.add_argument("--batch", type=int, default=None,
                    help="LM path: prompt batch size (default 4). Graph "
                         "path: dynamic batching — collect up to N queued "
                         "queries per batched execution (default off)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    # graph-query serving (the GraphService path)
    ap.add_argument("--graph", choices=GRAPH_ALGOS, default=None,
                    help="serve graph queries for this algorithm instead of LM decode")
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--updates", type=int, default=0,
                    help="graph path: interleave N streaming edge-addition "
                         "deltas (~1%% of |E| each) through the query stream "
                         "via a StreamingSession; reports per-version query "
                         "latency and update-apply latency")
    ap.add_argument("--pool", type=int, default=2)
    ap.add_argument("--artifact-dir", default=None,
                    help="graph path: warm-start from (or populate) a saved "
                         "Accelerator artifact directory — lowering is paid "
                         "once per (program, target, shape)")
    ap.add_argument("--autotune", action="store_true",
                    help="graph path: run the repro_torch.autotune search for "
                         "(program, graph bucket) before serving; the "
                         "service then resolves every submission through "
                         "the persisted TuningCache (cache hits skip the "
                         "search entirely)")
    ap.add_argument("--trace-dir", default=None,
                    help="graph path: enable repro_torch.telemetry tracing and "
                         "write trace.json (chrome://tracing) plus "
                         "requests.jsonl (per-request span dumps) to DIR "
                         "on exit; prints the queue-wait vs execution "
                         "latency split")
    ap.add_argument("--vertices", type=int, default=2000)
    ap.add_argument("--edges", type=int, default=16000)
    ap.add_argument("--backend", choices=("local", "distributed"), default="local")
    args = ap.parse_args(argv)

    if args.graph is not None:
        if args.batch is None:
            args.batch = 0  # graph path: dynamic batching off by default
        if args.updates:
            return serve_streaming(args)
        return serve_graph(args)
    if args.batch is None:
        args.batch = 4  # LM path: prompt batch size

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if not cfg.has_decoder:
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")
    if cfg.frontend != "none":
        raise SystemExit(f"{args.arch} takes {cfg.frontend} embeddings (its frontend is a "
                         "stub), not the token prompts this CLI serves")
    model = Model(cfg, dtype=torch.float32 if args.smoke else torch.bfloat16, device=device)
    model.init(torch.Generator(device=device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
                               ).to(device)
    t0 = time.perf_counter()
    toks = generate(model, prompts, args.gen_len)
    toks = toks.cpu()
    dt = time.perf_counter() - t0
    n = args.batch * (args.prompt_len + args.gen_len)
    print(f"generated {tuple(toks.shape)} tokens on {device} in {dt:.2f}s ({n / dt:.1f} tok/s)")
    print(toks.numpy()[:2])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
