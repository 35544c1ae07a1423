"""`repro_torch.analyze`: static analysis + lint over Graphitron programs.

    result = repro_torch.analyze(src_or_program)      # AnalysisResult
    for d in result.diagnostics:
        print(d.format())

``analyze`` accepts ``.gt`` source text, an embedded
:class:`~repro_torch.frontend.GraphProgram`, or a compiled
:class:`~repro_torch.core.program.Program`, runs the front-end + pass pipeline
(for text/embedded inputs it re-runs them *fresh*, never trusting the
shared module cache, so line/column provenance is always faithful to the
input you passed), and runs every dataflow analysis in
:mod:`repro_torch.analysis.analyses`. Front-end failures do not raise — they
surface as ``GT001``–``GT004`` error diagnostics, which is what a lint
driver wants.

Provenance is rendered per front-end: caret excerpts into the ``.gt``
text, ``file.py:lineno`` for embedded programs. The diagnostic *codes*
are front-end independent — a text program and its embedded twin produce
the same codes (tested as the parity matrix in tests/test_torch_analysis.py).

The ``python -m repro_torch.lint`` CLI (:mod:`repro_torch.lint`) and the ``strict=``
knob of :func:`repro_torch.compile` are thin wrappers over this entry point;
:meth:`GraphService.submit` consults :meth:`Program.diagnostics` to
reject error-level programs before registry admission.
"""
from __future__ import annotations

from typing import Dict, List

from .analyses import (  # noqa: F401 - re-exported analysis API
    DETERMINISTIC,
    RACY,
    REDUCTION_DETERMINISTIC,
    analyze_module,
    certificate_info,
    determinism_certificate,
    incremental_diagnostic,
    needs_shuffle,
    race_analysis,
)
from .diagnostics import CODES, SEVERITIES, AnalysisResult, Diagnostic, make  # noqa: F401

__all__ = [
    "AnalysisResult",
    "Diagnostic",
    "CODES",
    "SEVERITIES",
    "analyze",
    "analyze_module",
    "determinism_certificate",
    "certificate_info",
    "needs_shuffle",
    "DETERMINISTIC",
    "REDUCTION_DETERMINISTIC",
    "RACY",
]


# ---------------------------------------------------------------------------
# provenance rendering
# ---------------------------------------------------------------------------


def attach_text_provenance(diags, src: str) -> List[Diagnostic]:
    """Render caret excerpts into ``.gt`` source text."""
    from ..core.program import _excerpt

    out = []
    for d in diags:
        loc = _excerpt(src, d.line, d.col) if d.line else ""
        out.append(d.with_location(loc) if loc else d)
    return out


def embedded_files(gp) -> Dict[str, str]:
    """kernel/func name -> defining Python file, from the builder's
    symbol table (every decorated function keeps its original ``fn``)."""
    files: Dict[str, str] = {}
    for name, handle in getattr(gp, "_symbols", {}).items():
        code = getattr(getattr(handle, "fn", None), "__code__", None)
        if code is not None:
            files[name] = code.co_filename
    return files


def attach_embedded_provenance(diags, gp) -> List[Diagnostic]:
    """Render ``file.py:lineno`` locations (FIR lines of embedded programs
    are absolute Python line numbers)."""
    files = embedded_files(gp)
    default = files.get("main") or next(iter(sorted(files.values())), "")
    out = []
    for d in diags:
        f = files.get(d.kernel or "", default)
        if d.line and f:
            out.append(d.with_location(f"{f}:{d.line}"))
        else:
            out.append(d.with_location(f) if f else d)
    return out


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def _front_end_diag(code: str, exc: Exception) -> Diagnostic:
    line = getattr(exc, "line", 0) or getattr(exc, "lineno", 0) or 0
    col = getattr(exc, "col", 0) or 0
    return make(code, str(exc), line=int(line), col=int(col))


def analyze(src_or_program, options=None, *, shape=None) -> AnalysisResult:
    """Statically analyze a program; never raises on a bad program.

    ``shape`` (a :class:`~repro_torch.core.accelerator.GraphShape` or any object
    with ``n_edges``) additionally enables the dtype/overflow analyses
    (GT5xx). ``options`` selects the pass pipeline the analysis observes
    (fusion-merged kernels are analyzed in final form); ignored when a
    compiled ``Program`` is passed, which carries its own.
    """
    from ..core import mir, passes, semantic
    from ..core.lexer import LexError
    from ..core.options import CompileOptions
    from ..core.parser import ParseError, parse
    from ..core.program import Program

    if isinstance(src_or_program, Program):
        prog = src_or_program
        diags = analyze_module(prog.module, shape)
        diags = attach_text_provenance(diags, prog.source)
        return AnalysisResult(tuple(diags), determinism_certificate(prog.module),
                              prog.fingerprint)

    opts = options if options is not None else CompileOptions()
    embedded = not isinstance(src_or_program, str)
    if embedded and not hasattr(src_or_program, "to_fir"):
        raise TypeError(
            f"analyze() expects DSL source text, a GraphProgram, or a "
            f"compiled Program; got {type(src_or_program).__name__}"
        )

    def done(diags, module=None) -> AnalysisResult:
        cert = determinism_certificate(module) if module is not None else "unknown"
        if embedded:
            diags = attach_embedded_provenance(diags, src_or_program)
        else:
            diags = attach_text_provenance(diags, src_or_program)
        fp = mir.fingerprint(module) if module is not None else ""
        return AnalysisResult(tuple(diags), cert, fp)

    # front end (always fresh — provenance must match THIS input, not
    # whichever twin populated the shared module cache first)
    if embedded:
        from ..frontend.lowering import FrontendError

        try:
            fir_prog = src_or_program.to_fir()
        except FrontendError as e:
            return done([_front_end_diag("GT002", e)])
    else:
        try:
            fir_prog = parse(src_or_program)
        except LexError as e:
            return done([_front_end_diag("GT001", e)])
        except ParseError as e:
            return done([_front_end_diag("GT002", e)])
    try:
        module = semantic.analyze(fir_prog)
    except semantic.SemanticError as e:
        return done([_front_end_diag("GT003", e)])
    try:
        module = passes.run_pipeline(module, opts)
    except passes.PassError as e:
        return done([_front_end_diag("GT004", e)])
    return done(analyze_module(module, shape), module)
