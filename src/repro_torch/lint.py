"""``python -m repro_torch.lint``: the command-line face of :func:`repro_torch.analyze`.

    python -m repro_torch.lint file.gt [more.gt ...]
    python -m repro_torch.lint --json mypackage.programs:PAGERANK
    python -m repro_torch.lint --builtins          # all 8 shipped algorithms,
                                             # text AND embedded twins

Targets are ``.gt`` files or ``module:attr`` specs where the attribute is
DSL source text, an embedded :class:`~repro_torch.frontend.GraphProgram`, or a
zero-argument callable returning either. Exit status is 1 when any target
carries an error-level diagnostic (the same gate ``strict=`` compiles and
``GraphService.submit`` enforce), 0 otherwise — lint is CI-ready as-is.

``--json`` emits one machine-readable document for the whole run (the
shape CI archives as a job artifact); the default output is the human
``Diagnostic.format()`` rendering with caret excerpts / file:lineno
provenance per front-end.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from typing import Any, List, Tuple

from .analysis import AnalysisResult, analyze


def _load_spec(spec: str) -> Tuple[str, Any]:
    """Resolve one CLI target to (display name, analyzable object)."""
    if spec.endswith(".gt"):
        with open(spec, "r") as f:
            return spec, f.read()
    if ":" not in spec:
        raise SystemExit(
            f"repro_torch.lint: target {spec!r} is neither a .gt file nor a "
            f"module:attr spec"
        )
    mod_name, attr = spec.split(":", 1)
    try:
        mod = importlib.import_module(mod_name)
    except ImportError as e:
        raise SystemExit(f"repro_torch.lint: cannot import {mod_name!r}: {e}") from e
    try:
        obj = getattr(mod, attr)
    except AttributeError as e:
        raise SystemExit(
            f"repro_torch.lint: module {mod_name!r} has no attribute {attr!r}"
        ) from e
    if callable(obj) and not hasattr(obj, "to_fir"):
        obj = obj()
    return spec, obj


def _builtin_targets() -> List[Tuple[str, Any]]:
    """All 8 shipped algorithms: text sources plus their embedded twins."""
    from .serving.service import _named_algorithms

    targets: List[Tuple[str, Any]] = [
        (f"builtin:{name}", src)
        for name, src in sorted(_named_algorithms().items())
    ]
    try:
        from .algorithms import embedded
    except ImportError:
        return targets
    for name in getattr(embedded, "__all__", []):
        obj = getattr(embedded, name)
        # ready-built singletons only; their build_* factories would lint
        # the same programs twice
        if hasattr(obj, "to_fir"):
            targets.append((f"embedded:{name}", obj))
    return targets


def _report_text(name: str, result: AnalysisResult) -> str:
    lines = [f"== {name} =="]
    for d in result.diagnostics:
        lines.append(d.format())
    lines.append(
        f"   {len(result.errors)} error(s), {len(result.warnings)} "
        f"warning(s); determinism: {result.certificate}"
    )
    return "\n".join(lines)


def main(argv: List[str] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="Static analysis / lint for Graphitron programs.",
    )
    parser.add_argument(
        "targets", nargs="*",
        help=".gt files or module:attr specs (source text, GraphProgram, "
             "or a zero-arg factory of either)",
    )
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit one JSON document for the whole run",
    )
    parser.add_argument(
        "--builtins", action="store_true",
        help="lint the shipped algorithm table (text + embedded twins)",
    )
    args = parser.parse_args(argv)

    targets: List[Tuple[str, Any]] = []
    if args.builtins:
        targets.extend(_builtin_targets())
    for spec in args.targets:
        targets.append(_load_spec(spec))
    if not targets:
        parser.error("no targets: pass .gt files, module:attr specs, "
                     "or --builtins")

    results = [(name, analyze(obj)) for name, obj in targets]
    failed = any(res.errors for _, res in results)

    if args.as_json:
        doc = {
            "ok": not failed,
            "targets": {name: res.to_dict() for name, res in results},
        }
        print(json.dumps(doc, indent=2, sort_keys=True))
    else:
        for name, res in results:
            print(_report_text(name, res))
        n_err = sum(len(r.errors) for _, r in results)
        n_warn = sum(len(r.warnings) for _, r in results)
        print(f"lint: {len(results)} target(s), {n_err} error(s), "
              f"{n_warn} warning(s)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
