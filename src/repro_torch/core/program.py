"""Compile / bind / run: the public Program API.

    program = repro_torch.compile(src, options)     # compile once
    session = program.bind(graph)                   # bind to one graph + device
    result  = session.run(root=3, iters=20)         # parameterized execution

:func:`compile` accepts **two front ends for one compiler**:

* **Text**: a ``.gt`` source string in the paper's Fig. 1 syntax, run
  through the lexer, parser and semantic analysis.
* **Embedded**: a :class:`repro_torch.frontend.GraphProgram` built in
  Python (typed property/scalar handles plus ``@vertex_kernel`` /
  ``@edge_kernel`` functions whose bodies are lowered from the Python
  AST).

Both meet at the same MIR and run the MIR pass pipeline selected by
:class:`~.options.CompileOptions`. Front-end failures surface as
:class:`ProgramError`: text sources report the 1-based line/column and a
caret excerpt of the offending line; embedded programs report the Python
line of the offending decorated function.

Every host scalar declared in the program (``const root: int = 0;`` /
``GraphProgram.scalar("root", int, init=0)``) becomes a declared run-time
parameter; scalars declared without an initializer are required at
``run()``.

:meth:`Program.bind` places the program onto one graph on one device and
returns a reusable :class:`~.session.Session`. The device defaults to
``"cuda"``; without a GPU the caller must ask for ``device="cpu"``.
:meth:`Program.lower` instead makes an
:class:`~.accelerator.Accelerator` for a shape bucket, which binds any
graph of the bucket and saves to a directory artifact.

:func:`compile` is keyed by a content hash of the canonical serialized
MIR (:func:`~.mir.canonical_serialize`) and the options, in a bounded LRU
cache: the same program compiled twice is one :class:`Program`, an
embedded program and its text twin resolve to one entry, and two sources
differing only in comments or whitespace share an entry.
"""
from __future__ import annotations

import contextlib
import hashlib
import numbers
import threading
from collections import OrderedDict, namedtuple
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, TYPE_CHECKING

from . import mir, passes, semantic
from .lexer import LexError
from .options import CompileOptions
from .parser import ParseError, parse
from .. import telemetry as tel

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from ..frontend import GraphProgram
    from ..graph.storage import GraphData
    from .accelerator import Accelerator, GraphShape
    from .session import BatchSession, Session, SessionPool
    from .target import Target


class ProgramError(Exception):
    """Raised for bad compile/bind/run usage at the public API layer.

    Compile-time front-end failures carry a source location: ``line`` and
    ``col`` (1-based, 0 = unknown) point into the ``.gt`` text for the
    text front end, or into the decorated function's Python file (named in
    the message) for the embedded front end.
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


def program_fingerprint(mir_key: str, options: CompileOptions) -> str:
    """Cache key of a compiled Program: canonical MIR hash + options."""
    h = hashlib.sha256()
    h.update(mir_key.encode("ascii"))
    h.update(b"\x00")
    h.update(repr(options).encode("utf-8"))
    return h.hexdigest()


class Program:
    """A compiled Graphitron program, independent of any graph.

    Holds the optimized MIR module, the compile options it was built with,
    its content fingerprint (:func:`program_fingerprint`) and the declared
    run-time parameters. Each :meth:`bind` returns an isolated
    :class:`~.session.Session`.

    ``source`` is always ``.gt`` text: for embedded programs it is the
    :meth:`~repro_torch.frontend.GraphProgram.to_source` emission, so every
    compiled program can be read again by the text front end.
    """

    def __init__(self, module: mir.Module, options: CompileOptions, fingerprint: str,
                 source: str):
        self.module = module
        self.options = options
        self.fingerprint = fingerprint
        self.source = source
        self.params: Dict[str, ParamSpec] = {
            s.name: ParamSpec(s.name, s.scalar, required=s.init is None)
            for s in module.scalars.values()
        }

    def describe(self) -> str:
        """Textual MIR dump (the analogue of the generated-OpenCL listing)."""
        return self.module.describe()

    def diagnostics(self, shape=None):
        """Static-analysis findings over this program's (optimized) module.

        Returns an :class:`repro_torch.analysis.AnalysisResult`. The
        shape-free result is computed once and cached on the Program; pass
        a :class:`~.accelerator.GraphShape` to also run the dtype/overflow
        analyses (GT5xx, computed fresh per shape).

        The text and embedded front ends share one cached module per MIR
        fingerprint, so line numbers here belong to whichever twin was
        analyzed first. For provenance that matches a given source, call
        ``repro_torch.analyze(src)`` on that source.
        """
        from ..analysis import analyze

        if shape is not None:
            return analyze(self, shape=shape)
        cached = getattr(self, "_analysis", None)
        if cached is None:
            cached = analyze(self)
            self._analysis = cached
        return cached

    def __repr__(self) -> str:
        return (
            f"Program({self.fingerprint[:12]}, kernels={sorted(self.module.kernels)}, "
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

    def lower(self, target: "Optional[Target]" = None, shape: "Optional[GraphShape]" = None,
              *, graph: "Optional[GraphData]" = None, bucket: bool = False,
              tuned: bool = False, tuning_cache=None,
              device: Optional[str] = None) -> "Accelerator":
        """Lower this program for a (target, shape bucket) on one device.

        The returned :class:`~.accelerator.Accelerator` holds every kernel
        lowered with the graph's binding arrays as arguments, so
        ``accelerator.bind(g)`` is a shape check plus the graph's upload,
        and any number of graphs of the bucket share the lowering. On
        ``"cuda"`` lowering builds (or finds built) and loads the CUDA
        libraries the graph path launches. Pass ``shape=GraphShape(...)``
        or ``graph=`` to take the bucket from a concrete graph;
        ``bucket=True`` (with ``graph=``) rounds its logical counts up to a
        geometric bucket (:meth:`GraphShape.bucket_for`), and the caller
        binds ``graph.pad_to(shape.n_vertices, shape.n_edges)``. ``target``
        defaults to ``Target()``; ``device`` is as for :meth:`bind`:
        ``None`` means ``"cuda"``, which raises without a GPU unless the
        caller asks for ``device="cpu"``.

        ``tuned=True`` consults the :mod:`repro_torch.autotune` TuningCache
        for this program's (MIR fingerprint x shape bucket) and, on a hit,
        lowers with the tuned Target instead, stamping the config into the
        accelerator (``Accelerator.tuned``, saved in the manifest). It is a
        lookup with zero search trials (``python -m repro_torch.autotune``
        or :func:`repro_torch.autotune.autotune` fill the cache); on a miss
        the given or default target is used unchanged. ``tuning_cache``
        overrides the default cache (``<artifact store>/tuning``).
        """
        from .accelerator import Accelerator, GraphShape
        from .target import Target

        if shape is None:
            if graph is None:
                raise ProgramError(
                    "Program.lower needs a shape bucket: pass "
                    "shape=GraphShape(...) or graph=<GraphData>"
                )
            if bucket:
                shape = GraphShape.bucket_for(graph.n_vertices_logical,
                                              graph.n_edges_logical,
                                              weighted=graph.weighted)
            else:
                shape = GraphShape.of(graph)
        if target is None:
            target = Target()
        tuned_stamp = None
        if tuned:
            from ..autotune import (
                TuningCache, default_tuning_dir, program_mir_fingerprint, shape_bucket,
            )

            cache = tuning_cache if tuning_cache is not None else \
                TuningCache(default_tuning_dir())
            cfg = cache.get(program_mir_fingerprint(self),
                            shape_bucket(graph=graph, shape=shape), kind=target.kind)
            if cfg is not None:
                target = cfg.target
                tuned_stamp = cfg.to_dict()
        return Accelerator(self, target, shape, device=device, _tuned=tuned_stamp)

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


# ---------------------------------------------------------------------------
# content-hashed program cache (bounded LRU)
# ---------------------------------------------------------------------------


class _LRU:
    """A small LRU map with functools-style counters.

    NOT internally locked: all access goes through ``_CACHE_LOCK`` below
    (the caches cross-reference each other, so one lock is simplest).
    """

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._od: "OrderedDict[str, Any]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key):
        if key is None or key not in self._od:
            self.misses += 1
            return None
        self._od.move_to_end(key)
        self.hits += 1
        return self._od[key]

    def setdefault(self, key, value):
        cur = self._od.get(key)
        if cur is not None:
            self._od.move_to_end(key)
            return cur
        self._od[key] = value
        self._evict()
        return value

    def put(self, key, value):
        self._od[key] = value
        self._od.move_to_end(key)
        self._evict()

    def _evict(self):
        while len(self._od) > self.maxsize:
            self._od.popitem(last=False)
            self.evictions += 1

    def resize(self, maxsize: int):
        self.maxsize = maxsize
        self._evict()

    def clear(self):
        self._od.clear()
        self.hits = self.misses = self.evictions = 0

    def __len__(self):
        return len(self._od)

    def __contains__(self, key):
        return key in self._od


#: Default Program cache bound: a long-lived process compiles many distinct
#: programs; an unbounded dict is a slow leak.
DEFAULT_PROGRAM_CACHE_SIZE = 64

# keyed by program_fingerprint(mir_key, options)
_PROGRAM_CACHE = _LRU(DEFAULT_PROGRAM_CACHE_SIZE)
# the analyzed MIR module is options-independent: cached on the MIR
# fingerprint alone, so sweeps over options do not re-run the analysis
_MODULE_CACHE = _LRU(DEFAULT_PROGRAM_CACHE_SIZE)
# sha256(raw text) -> MIR fingerprint: recompiling the same text skips the
# lexer, parser and analyzer
_TEXT_KEYS = _LRU(DEFAULT_PROGRAM_CACHE_SIZE)
_CACHE_LOCK = threading.Lock()

ProgramCacheInfo = namedtuple(
    "ProgramCacheInfo", ["hits", "misses", "evictions", "maxsize", "currsize"]
)


def program_cache_info() -> ProgramCacheInfo:
    """functools-style counters of the compiled-Program LRU cache."""
    with _CACHE_LOCK:
        c = _PROGRAM_CACHE
        return ProgramCacheInfo(c.hits, c.misses, c.evictions, c.maxsize, len(c))


def set_program_cache_limit(maxsize: int) -> None:
    """Resize the Program cache (module/text memos track the same bound)."""
    if maxsize < 1:
        raise ValueError("program cache size must be >= 1")
    with _CACHE_LOCK:
        _PROGRAM_CACHE.resize(maxsize)
        _MODULE_CACHE.resize(maxsize)
        _TEXT_KEYS.resize(maxsize)


def _analyze_text(src: str) -> Tuple[mir.Module, str]:
    """Text front end: source -> (analyzed module, MIR fingerprint)."""
    src_key = hashlib.sha256(src.encode("utf-8")).hexdigest()
    with _CACHE_LOCK:
        mir_key = _TEXT_KEYS.get(src_key)
        module = _MODULE_CACHE.get(mir_key) if mir_key else None
    if module is not None:
        return module, mir_key
    try:
        fir_prog = parse(src)
    except (LexError, ParseError) as e:
        raise _front_end_error(e, src) from e
    try:
        module = semantic.analyze(fir_prog)
    except semantic.SemanticError as e:
        raise _front_end_error(e, src) from e
    mir_key = mir.fingerprint(module)
    with _CACHE_LOCK:
        # another thread may have raced us; keep the first base module
        module = _MODULE_CACHE.setdefault(mir_key, module)
        _TEXT_KEYS.put(src_key, mir_key)
    return module, mir_key


def _analyze_embedded(gp: "GraphProgram") -> Tuple[mir.Module, str, str]:
    """Embedded front end: GraphProgram -> (module, MIR key, .gt source).

    The (MIR key, source) pair is memoized on the GraphProgram itself
    (``_identity``, invalidated by new declarations), so repeated compiles
    of the same builder skip to_fir/analyze/dump: the embedded analogue of
    the text path's ``_TEXT_KEYS`` memo.
    """
    ident = getattr(gp, "_identity", None)
    if ident is not None:
        mir_key, source_text = ident
        with _CACHE_LOCK:
            module = _MODULE_CACHE.get(mir_key)
        if module is not None:
            return module, mir_key, source_text
    from ..frontend.lowering import FrontendError  # deferred: no cycle at load

    try:
        fir_prog = gp.to_fir()
        source_text = gp.to_source()
    except FrontendError as e:
        raise ProgramError(f"embedded program {gp.name!r}: {e}") from e
    try:
        module = semantic.analyze(fir_prog)
    except semantic.SemanticError as e:
        line = getattr(e, "line", 0) or 0
        raise ProgramError(
            f"embedded program {gp.name!r}: {e}"
            + (f" (Python source line {line})" if line else ""),
            line,
        ) from e
    mir_key = mir.fingerprint(module)
    with _CACHE_LOCK:
        module = _MODULE_CACHE.setdefault(mir_key, module)
    with contextlib.suppress(AttributeError):  # exotic duck types
        gp._identity = (mir_key, source_text)
    return module, mir_key, source_text


def compile_program(src: "str | GraphProgram", options: Optional[CompileOptions] = None,
                    *, strict: bool = False) -> Program:
    """Compile DSL source, text or embedded, into a :class:`Program`.

    ``src`` is a ``.gt`` source string or a
    :class:`repro_torch.frontend.GraphProgram`. The cache key is a content
    hash of the canonical serialized MIR plus the options: the same
    program returns the same Program whichever front end authored it, and
    other options compile anew. Under tracing this opens the ``compile``
    span.

    ``strict=True`` also runs the static analysis (:mod:`repro_torch.analysis`)
    over the source: error-level diagnostics (e.g. GT101 scatter races)
    raise :class:`ProgramError` with their provenance; warnings collect on
    the returned Program (``program.diagnostics()``). Strictness is not
    part of the cache key: it gates raising, not the compiled program.
    """
    tr = tel.get()
    if not tr.enabled:
        return _compile_impl(src, options, strict, tel.NULL_SPAN)
    with tr.span("compile") as sp:
        return _compile_impl(src, options, strict, sp)


def _compile_impl(src, options, strict, sp) -> Program:
    if isinstance(src, str):
        sp.set(frontend="text")
        module, mir_key = _analyze_text(src)
        source_text = src
    elif hasattr(src, "to_fir") and hasattr(src, "to_source"):
        sp.set(frontend="embedded")
        module, mir_key, source_text = _analyze_embedded(src)
    else:
        raise ProgramError(
            f"expected DSL source text or a GraphProgram, got {type(src).__name__}"
        )
    opts = options if options is not None else CompileOptions()
    key = program_fingerprint(mir_key, opts)
    sp.set(fingerprint=key[:16])
    with _CACHE_LOCK:
        prog = _PROGRAM_CACHE.get(key)
    if prog is not None:
        sp.set(cache_hit=True)
        if strict:
            _check_strict(src, opts)
        return prog
    sp.set(cache_hit=False)
    # the pass pipeline works on a copy: the cached base module stays
    # pristine for other option sets
    prog = Program(passes.run_pipeline(module, opts), opts, key, source_text)
    with _CACHE_LOCK:
        prog = _PROGRAM_CACHE.setdefault(key, prog)
    if strict:
        _check_strict(src, opts)
    return prog


def _check_strict(src, opts: CompileOptions) -> None:
    """Raise ProgramError on error-level analysis findings.

    Runs the front end again through ``repro_torch.analyze`` so the
    provenance in the message is that of THIS input (caret excerpts for
    text, Python file:lineno for embedded): the shared module cache may
    hold the other twin's line numbers.
    """
    from ..analysis import analyze as _analyze

    result = _analyze(src, options=opts)
    if result.errors:
        first = result.errors[0]
        detail = "\n".join(d.format() for d in result.errors)
        raise ProgramError(
            f"strict compile rejected the program "
            f"({len(result.errors)} error-level diagnostic(s)):\n{detail}",
            first.line, first.col,
        )


def clear_program_cache() -> None:
    """Drop all cached programs and modules (test isolation / memory)."""
    with _CACHE_LOCK:
        _PROGRAM_CACHE.clear()
        _MODULE_CACHE.clear()
        _TEXT_KEYS.clear()


def program_cache_size() -> int:
    with _CACHE_LOCK:
        return len(_PROGRAM_CACHE)


# `repro_torch.compile(src, options)` reads naturally at call sites; the
# builtin is still reachable as `builtins.compile`.
compile = compile_program
