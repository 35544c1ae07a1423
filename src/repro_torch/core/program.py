"""Compile-once / bind-many front door of the toolchain.

    program = repro_torch.compile(src, options)     # compile once
    session = program.bind(graph)                   # bind to one graph + device
    result  = session.run(root=3, iters=20)         # parameterized execution

:func:`compile` takes a ``.gt`` source string in the paper's Fig. 1 syntax,
runs the front end (lexer, parser, semantic analysis) and the MIR pass
pipeline selected by :class:`~.options.CompileOptions`, and returns a
:class:`Program`. Front-end failures surface as :class:`ProgramError` with
the 1-based line/column and a caret excerpt of the offending line.

Every host scalar declared in the program (``const root: int = 0;``)
becomes a declared run-time parameter; scalars declared without an
initializer are required at ``run()``.

:meth:`Program.bind` places the program onto one graph on one device and
returns a reusable :class:`~.session.Session`. The device defaults to
``"cuda"``; without a GPU the caller must ask for ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
import numbers
from dataclasses import dataclass
from typing import Any, Dict, Optional, TYPE_CHECKING

from . import mir, passes, semantic
from .lexer import LexError
from .options import CompileOptions
from .parser import ParseError, parse

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from ..graph.storage import GraphData
    from .session import BatchSession, Session, SessionPool
    from .target import Target


class ProgramError(Exception):
    """Raised for bad compile/bind/run usage at the public API layer.

    Compile-time front-end failures carry a source location: ``line`` and
    ``col`` (1-based, 0 = unknown) point into the ``.gt`` text.
    """

    def __init__(self, msg: str, line: int = 0, col: int = 0):
        super().__init__(msg)
        self.line = line
        self.col = col


def _excerpt(src: str, line: int, col: int) -> str:
    """A diagnostic excerpt: the offending source line plus a caret."""
    lines = src.splitlines()
    if not (1 <= line <= len(lines)):
        return ""
    text = lines[line - 1]
    out = f"\n  {line} | {text}"
    if col >= 1:
        out += "\n  " + " " * len(str(line)) + " | " + " " * (col - 1) + "^"
    return out


def _front_end_error(exc: Exception, src: str) -> ProgramError:
    """Wrap a lex/parse/semantic failure in a located ProgramError."""
    line = getattr(exc, "line", 0) or 0
    col = getattr(exc, "col", 0) or 0
    return ProgramError(f"{exc}{_excerpt(src, line, col)}", line, col)


@dataclass(frozen=True)
class ParamSpec:
    """One declared run-time parameter (a host scalar of the program)."""

    name: str
    scalar: str  # 'int' | 'float' | 'bool'
    required: bool  # declared without an initializer

    def describe(self) -> str:
        kind = "required" if self.required else "optional"
        return f"{self.name}: {self.scalar} ({kind})"


def _coerce_param(spec: ParamSpec, value: Any):
    """Validate + coerce one user-supplied parameter to its declared type."""
    # multi-element arrays raise on the ambiguous comparisons -> mismatch
    with contextlib.suppress(TypeError, ValueError):
        if spec.scalar == "bool":
            if isinstance(value, (bool,)) or value in (0, 1):
                return bool(value)
        elif spec.scalar == "int":
            if isinstance(value, bool):
                return int(value)
            if isinstance(value, numbers.Integral):
                return int(value)
            if isinstance(value, numbers.Real) and float(value).is_integer():
                return int(value)
        elif (spec.scalar == "float" and isinstance(value, numbers.Real)
              and not isinstance(value, bool)):
            return float(value)
    raise ProgramError(
        f"parameter {spec.name!r} expects {spec.scalar}, got "
        f"{type(value).__name__} ({value!r})"
    )


class Program:
    """A compiled Graphitron program, independent of any graph.

    Holds the optimized MIR module, the compile options it was built with,
    and the declared run-time parameters. Each :meth:`bind` returns an
    isolated :class:`~.session.Session`.
    """

    def __init__(self, module: mir.Module, options: CompileOptions, source: str):
        self.module = module
        self.options = options
        self.source = source
        self.params: Dict[str, ParamSpec] = {
            s.name: ParamSpec(s.name, s.scalar, required=s.init is None)
            for s in module.scalars.values()
        }

    def describe(self) -> str:
        """Textual MIR dump (the analogue of the generated-OpenCL listing)."""
        return self.module.describe()

    def __repr__(self) -> str:
        return (
            f"Program(kernels={sorted(self.module.kernels)}, "
            f"params=[{', '.join(p.describe() for p in self.params.values())}])"
        )

    def validate_params(self, overrides: Dict[str, Any]) -> Dict[str, Any]:
        """Check run() kwargs against the declared parameters.

        Unknown names, missing required parameters, and type mismatches all
        raise :class:`ProgramError` with an actionable message.
        """
        unknown = sorted(set(overrides) - set(self.params))
        if unknown:
            declared = ", ".join(p.describe() for p in self.params.values()) or "<none>"
            raise ProgramError(
                f"unknown run-time parameter(s) {unknown}; this program declares: "
                f"{declared}. Declare a host scalar (`const name: int = 0;`) to "
                f"add a parameter."
            )
        out: Dict[str, Any] = {}
        for name, spec in self.params.items():
            if name in overrides:
                out[name] = _coerce_param(spec, overrides[name])
            elif spec.required:
                raise ProgramError(
                    f"missing required parameter {name!r} (declared without an "
                    f"initializer); pass {name}=<{spec.scalar}> to run()"
                )
        return out

    def bind(self, graph: "GraphData", *, target: "Optional[Target]" = None,
             device: Optional[str] = None, argv: Optional[list] = None) -> "Session":
        """Place this program onto ``graph`` on one device.

        ``target`` picks the memory-access knobs (default :class:`Target`).
        ``device`` defaults to ``"cuda"``; binding raises when no GPU is
        available, unless the caller asks for ``device="cpu"``, where the
        hand-written kernels' plain PyTorch versions run instead.
        """
        from .session import Session

        return Session(self, graph, target=target, device=device, argv=argv)

    def bind_batch(self, graph: "GraphData", *, target: "Optional[Target]" = None,
                   device: Optional[str] = None, argv: Optional[list] = None,
                   max_batch: Optional[int] = None, msbfs: bool = True) -> "BatchSession":
        """Place this program onto ``graph`` for batched multi-query runs.

        The returned :class:`~.session.BatchSession` answers a whole list of
        parameter bindings per execution, with one set of launches: state
        carries a leading batch axis, host control flow runs with per-query
        masks, and BFS-like programs take the bit-packed multi-source path
        (``msbfs=False`` turns it off). Results are bit-identical to
        sequential :meth:`bind` + ``run`` calls. ``target`` and ``device``
        are as for :meth:`bind`: without a GPU it raises unless
        ``device="cpu"``.
        """
        from .session import BatchSession

        return BatchSession(self, graph, target=target, device=device, argv=argv,
                            max_batch=max_batch, msbfs=msbfs)

    def pool(self, graph: "GraphData", size: int = 2, *, target: "Optional[Target]" = None,
             device: Optional[str] = None, argv: Optional[list] = None, batch: int = 0,
             batch_wait_s: float = 0.002) -> "SessionPool":
        """A :class:`~.session.SessionPool` of ``size`` sessions bound to
        ``graph`` for concurrent and batched query serving (``batch > 1``
        turns on the dynamic batcher)."""
        from .session import SessionPool

        return SessionPool(self, graph, size, target=target, device=device, argv=argv,
                           batch=batch, batch_wait_s=batch_wait_s)


def compile_program(src: str, options: Optional[CompileOptions] = None) -> Program:
    """Compile a ``.gt`` source string into a :class:`Program`."""
    if not isinstance(src, str):
        raise ProgramError(f"expected DSL source text, got {type(src).__name__}")
    try:
        fir_prog = parse(src)
    except (LexError, ParseError) as e:
        raise _front_end_error(e, src) from e
    try:
        module = semantic.analyze(fir_prog)
    except semantic.SemanticError as e:
        raise _front_end_error(e, src) from e
    opts = options if options is not None else CompileOptions()
    return Program(passes.run_pipeline(module, opts), opts, src)


# `repro_torch.compile(src, options)` reads naturally at call sites; the
# builtin is still reachable as `builtins.compile`.
compile = compile_program
