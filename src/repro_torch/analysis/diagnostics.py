"""Typed diagnostics for the MIR static-analysis framework.

Every finding :mod:`repro_torch.analysis.analyses` emits is a :class:`Diagnostic`
with a **stable code** (the table below; golden-tested and documented in
ROADMAP.md), a severity, and provenance fields. Codes never change meaning
across releases — tooling may match on them.

==========  ========  ==============================================================
code        severity  meaning
==========  ========  ==============================================================
``GT001``   error     source does not lex
``GT002``   error     source does not parse
``GT003``   error     semantic analysis rejected the program
``GT004``   error     pass pipeline rejected the program/options
``GT101``   error     scatter-write race: per-edge plain ``=`` write whose value
                      varies per edge (not a commutative-associative reduction)
``GT102``   error     conflicting reduction operators on one scattered property
                      within a single (possibly fusion-merged) kernel
``GT201``   info      determinism certificate (deterministic /
                      reduction-deterministic / racy)
``GT202``   info      streaming-incremental eligibility verdict
``GT301``   warning   property read before any initialization (relies on
                      implicit zero-filled buffers)
``GT302``   warning   write-only property: written but never read by any kernel
                      or host statement
``GT401``   warning   ``while`` condition never updated inside the loop body
``GT402``   warning   frontier loop never updates the frontier properties
``GT501``   warning   int32 accumulator over an |E|-scaled sum may overflow at
                      the given :class:`~repro_torch.core.accelerator.GraphShape`
``GT502``   error     |E| exceeds the int32 edge-index space of the CSR layout
==========  ========  ==============================================================

Suppression: analyses are advisory by default — ``repro_torch.compile`` only
raises under ``strict=True`` and :meth:`GraphService.submit` only rejects
error-level findings. There is no per-line pragma; restructure the program
(use a ``min=``/``max=``/``+=`` reduction for scattered writes) or compile
non-strict to proceed past warnings.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

#: severity levels, most severe first (sort key: index in this tuple)
SEVERITIES: Tuple[str, ...] = ("error", "warning", "info")

#: code -> (severity, one-line summary); the public registry of stable codes
CODES: Dict[str, Tuple[str, str]] = {
    "GT001": ("error", "source does not lex"),
    "GT002": ("error", "source does not parse"),
    "GT003": ("error", "semantic analysis rejected the program"),
    "GT004": ("error", "pass pipeline rejected the program/options"),
    "GT101": ("error", "scatter-write race (non-reduction per-edge write)"),
    "GT102": ("error", "conflicting reduce ops on one scattered property"),
    "GT201": ("info", "determinism certificate"),
    "GT202": ("info", "streaming-incremental eligibility"),
    "GT301": ("warning", "property read before initialization"),
    "GT302": ("warning", "write-only property (dead writes)"),
    "GT401": ("warning", "while condition never updated in loop body"),
    "GT402": ("warning", "frontier loop never updates the frontier"),
    "GT501": ("warning", "int32 accumulator may overflow at |E| scale"),
    "GT502": ("error", "|E| exceeds int32 edge-index space"),
}


@dataclass(frozen=True)
class Diagnostic:
    """One static-analysis finding, front-end independent.

    ``line``/``col`` are 1-based positions into whatever source the FIR
    was built from: ``.gt`` text for the text front-end, the decorated
    function's Python file for the embedded front-end (``col`` is then 0).
    ``location`` is the rendered provenance — a caret excerpt for text
    sources, ``file.py:lineno`` for embedded programs — attached by
    :func:`repro_torch.analyze` / :meth:`Program.diagnostics`, which know which
    front-end authored the program.
    """

    code: str
    severity: str  # 'error' | 'warning' | 'info'
    message: str
    kernel: Optional[str] = None
    prop: Optional[str] = None
    line: int = 0
    col: int = 0
    location: str = field(default="", compare=False)

    def with_location(self, location: str) -> "Diagnostic":
        return dataclasses.replace(self, location=location)

    @property
    def sort_key(self):
        sev = SEVERITIES.index(self.severity) if self.severity in SEVERITIES else 99
        return (sev, self.code, self.line, self.col, self.message)

    def format(self) -> str:
        """One human-readable block: ``CODE severity: message`` + context."""
        ctx = []
        if self.kernel:
            ctx.append(f"kernel {self.kernel}")
        if self.prop:
            ctx.append(f"property {self.prop}")
        head = f"{self.code} {self.severity}: {self.message}"
        if ctx:
            head += f" [{', '.join(ctx)}]"
        if self.location:
            head += self.location if self.location.startswith("\n") \
                else f" ({self.location})"
        return head

    def to_dict(self) -> dict:
        """JSON-ready form (the ``repro_torch.lint --json`` record shape)."""
        return {
            "code": self.code,
            "severity": self.severity,
            "message": self.message,
            "kernel": self.kernel,
            "prop": self.prop,
            "line": self.line,
            "col": self.col,
            "location": self.location,
        }


def make(code: str, message: str, *, kernel: Optional[str] = None,
         prop: Optional[str] = None, line: int = 0, col: int = 0) -> Diagnostic:
    """Build a Diagnostic with the severity registered for its code."""
    if code not in CODES:
        raise ValueError(f"unknown diagnostic code {code!r}")
    return Diagnostic(code=code, severity=CODES[code][0], message=message,
                      kernel=kernel, prop=prop, line=line, col=col)


@dataclass(frozen=True)
class AnalysisResult:
    """Everything :func:`repro_torch.analyze` derives from one program.

    ``certificate`` is the determinism tier (``deterministic`` /
    ``reduction-deterministic`` / ``racy``) — the same string
    ``accelerator.report()`` and saved artifact manifests carry.
    """

    diagnostics: Tuple[Diagnostic, ...]
    certificate: str
    fingerprint: str = ""

    @property
    def errors(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == "error")

    @property
    def warnings(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == "warning")

    @property
    def infos(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == "info")

    @property
    def ok(self) -> bool:
        """No error-level findings (warnings and infos may remain)."""
        return not self.errors

    def codes(self) -> Tuple[str, ...]:
        """Sorted unique diagnostic codes (the front-end parity invariant)."""
        return tuple(sorted({d.code for d in self.diagnostics}))

    def render(self) -> str:
        lines = [d.format() for d in self.diagnostics]
        lines.append(
            f"{len(self.errors)} error(s), {len(self.warnings)} warning(s), "
            f"{len(self.infos)} info(s); determinism: {self.certificate}"
        )
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "fingerprint": self.fingerprint,
            "certificate": self.certificate,
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }
