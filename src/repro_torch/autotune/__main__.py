"""Offline autotuning CLI: search once, serve tuned forever.

    PYTHONPATH=src python -m repro_torch.autotune --algo bfs \
        --vertices 2000 --edges 16000 --param root=0

    PYTHONPATH=src python -m repro_torch.autotune path/to/program.gt \
        --param root=0 --store /var/cache/repro-torch-artifacts --device cpu

Compiles the program (a built-in algorithm name via ``--algo`` or a
``.gt`` file path), generates a synthetic power-law probe graph of the
requested bucket, runs the :class:`~repro_torch.autotune.AutoTuner` search,
and persists the winning :class:`~repro_torch.autotune.TunedConfig` into the
TuningCache under the artifact store — after which
``program.lower(..., tuned=True)``, ``repro_torch.run``, and
``repro_torch.serve()`` pick the tuned Target with zero re-search.
Trials run on ``--device`` (default ``cuda``, which needs a GPU).
"""
from __future__ import annotations

import argparse
import json
import sys


def _parse_param(text: str):
    name, _, raw = text.partition("=")
    if not _:
        raise argparse.ArgumentTypeError(
            f"--param expects name=value, got {text!r}"
        )
    for conv in (int, float):
        try:
            return name, conv(raw)
        except ValueError:
            continue
    if raw.lower() in ("true", "false"):
        return name, raw.lower() == "true"
    raise argparse.ArgumentTypeError(
        f"--param {name}: value {raw!r} is not an int/float/bool"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.autotune", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("source", nargs="?", default=None,
                    help=".gt program file to tune (or use --algo)")
    ap.add_argument("--algo", default=None,
                    help="built-in algorithm name (bfs, pagerank, sssp, ...)")
    ap.add_argument("--vertices", type=int, default=2000)
    ap.add_argument("--edges", type=int, default=16000)
    ap.add_argument("--weighted", action="store_true",
                    help="probe with a weighted graph (sssp-class programs)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--param", action="append", type=_parse_param,
                    default=[], metavar="NAME=VALUE",
                    help="probe-query run-time parameter (repeatable)")
    ap.add_argument("--store", default=None,
                    help="artifact store dir; the TuningCache lives in "
                         "<store>/tuning (default: $REPRO_TORCH_ARTIFACT_DIR / "
                         "~/.cache/repro-torch-artifacts)")
    ap.add_argument("--reps", type=int, default=3,
                    help="best-of-N repetitions per candidate")
    ap.add_argument("--max-candidates", type=int, default=12)
    ap.add_argument("--force", action="store_true",
                    help="re-search even when the cache already holds a "
                         "config for this (program, bucket)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the TuneReport as JSON")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from ..core.program import compile_program
    from ..graph import generators
    from ..serving.service import NAMED_ALGORITHMS

    from . import AutoTuner, TuningCache, default_tuning_dir, tuning_dir_for

    if (args.source is None) == (args.algo is None):
        ap.error("pass exactly one of a .gt file path or --algo NAME")
    if args.algo is not None:
        if args.algo not in NAMED_ALGORITHMS:
            ap.error(f"unknown --algo {args.algo!r}; built-ins: "
                     f"{', '.join(sorted(NAMED_ALGORITHMS))}")
        src = NAMED_ALGORITHMS[args.algo]
        weighted = args.weighted or args.algo in ("sssp", "cgaw")
    else:
        try:
            with open(args.source) as f:
                src = f.read()
        except OSError as e:
            ap.error(f"cannot read {args.source}: {e}")
        weighted = args.weighted

    program = compile_program(src)
    graph = generators.power_law(
        args.vertices, args.edges, seed=args.seed, weighted=weighted
    )
    cache = TuningCache(
        tuning_dir_for(args.store) if args.store else default_tuning_dir()
    )
    tuner = AutoTuner(cache, reps=args.reps,
                      max_candidates=args.max_candidates, device=args.device)
    report = tuner.tune(program, graph, params=dict(args.param),
                        force=args.force)
    if args.as_json:
        print(json.dumps({
            "config": report.config.to_dict(),
            "trials": report.trials,
            "cache_hit": report.cache_hit,
            "candidates": report.candidates,
            "pruned": list(report.pruned),
            "measurements": report.measurements,
            "cache": cache.stats(),
            "store": cache.store_dir,
        }, indent=2, sort_keys=True))
    else:
        print(report.describe())
        print(f"cache: {cache!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
