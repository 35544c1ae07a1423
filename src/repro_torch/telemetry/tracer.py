"""Structured tracing core: thread-safe Tracer with nestable spans.

Between the ``EngineStats`` scalars of a run and its wall time the
runtime is a black box; this module is the data plane that opens it. A
:class:`Tracer` records **spans** — named, timed
intervals with typed attributes (program fingerprint, target, shape
bucket, batch K, graph version, tenant, ...) and parent links — from
which the exporters (:mod:`repro_torch.telemetry.export`) derive Chrome
``trace_event`` JSON, Prometheus-style text, and per-run summaries.

Design constraints, in priority order:

1. **Near-zero cost when disabled.** The module-level default is a
   :class:`NullTracer` whose ``span()`` returns one preallocated no-op
   context manager; instrumented hot loops additionally guard on
   ``tracer.enabled`` so a disabled tracer costs one attribute check per
   launch.
2. **Thread-safe, cross-thread trees.** Span nesting rides a
   ``contextvars.ContextVar`` (so concurrent sessions on one tracer do
   not interleave parents); work handed to another thread (the serving
   scheduler, session pools) carries an explicit :class:`SpanContext`
   token captured at submit time and passed as ``parent=``.
3. **Bounded memory.** Finished spans go to a bounded buffer (drops are
   counted, never silent); per-span-name duration histograms reuse the
   fixed-bucket :class:`~repro_torch.telemetry.histogram.
   LatencyHistogram`, so a long-lived traced service aggregates without
   per-sample growth even after the buffer saturates.

Durations use ``time.perf_counter()`` throughout; the tracer records one
wall-clock anchor at construction so exporters can place spans on an
absolute timeline without per-span ``time.time()`` calls.
Head-based **trace sampling** keeps always-on tracing cheap at high QPS:
``Tracer(sample=0.1)`` (or ``repro_torch.telemetry.enable(sample=0.1)``) makes
the keep-or-drop decision once per *root* span — a dropped root installs
a sampled-out marker in the context so every descendant span of that
trace is a preallocated no-op, never a half-recorded tree. Sampling is
seedable for deterministic tests.
"""
from __future__ import annotations

import random
import threading
import time
from contextvars import ContextVar
from typing import Any, Dict, List, Optional, Tuple

from .histogram import LatencyHistogram

__all__ = [
    "Span",
    "SpanContext",
    "Tracer",
    "NullTracer",
    "NULL_SPAN",
]

# (trace_id, span_id) of the innermost open span in this execution context
_CURRENT: ContextVar[Optional[Tuple[int, int]]] = ContextVar(
    "repro_torch_telemetry_current", default=None
)

# ambient marker installed by a sampled-out root span: descendants see a
# negative trace id and short-circuit to NULL_SPAN (whole-trace drops,
# never partial trees)
_SAMPLED_OUT = (-1, -1)

# distinct span names get their own histogram up to this many; the rest
# aggregate under "other" (guards against unbounded label cardinality)
_MAX_HIST_NAMES = 256


def _new_histogram():
    return LatencyHistogram()


class SpanContext:
    """Immutable handoff token: lets another thread parent under a span."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int) -> None:
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:
        return f"SpanContext(trace={self.trace_id}, span={self.span_id})"


class Span:
    """One named, timed interval. Context manager; reentrant-unsafe.

    ``set(**attrs)`` adds attributes after entry (e.g. a launch records
    its compacted-vs-full decision once it is made). Attribute values
    should be JSON-representable scalars; exporters coerce the rest.
    """

    __slots__ = (
        "name", "span_id", "parent_id", "trace_id", "t_start", "t_end",
        "attrs", "thread_id", "thread_name", "_tracer", "_token",
    )

    def __init__(self, tracer: "Tracer", name: str, span_id: int,
                 trace_id: int, parent_id: Optional[int],
                 attrs: Dict[str, Any]) -> None:
        self.name = name
        self.span_id = span_id
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.t_start = 0.0
        self.t_end = 0.0
        th = threading.current_thread()
        self.thread_id = th.ident or 0
        self.thread_name = th.name
        self._tracer = tracer
        self._token = None

    @property
    def duration_s(self) -> float:
        return max(0.0, self.t_end - self.t_start)

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def __enter__(self) -> "Span":
        self._token = _CURRENT.set((self.trace_id, self.span_id))
        self.t_start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t_end = time.perf_counter()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        self._tracer._finish(self)
        return False


class _NullSpan:
    """The no-op span: every operation is a constant-time nothing."""

    __slots__ = ()

    def set(self, **attrs: Any) -> "_NullSpan":
        return self

    def context(self) -> None:
        return None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _SampledOutSpan:
    """Root span of a dropped trace: records nothing, but installs the
    sampled-out marker so every descendant short-circuits to NULL_SPAN.
    One instance per dropped root (it carries a context token)."""

    __slots__ = ("_token",)

    def __init__(self) -> None:
        self._token = None

    def set(self, **attrs: Any) -> "_SampledOutSpan":
        return self

    def context(self) -> None:
        return None  # nothing to parent under: the trace does not exist

    def __enter__(self) -> "_SampledOutSpan":
        self._token = _CURRENT.set(_SAMPLED_OUT)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        return False


class Tracer:
    """Thread-safe span recorder with bounded retention.

    One tracer instance serves the whole process (installed via
    :func:`repro_torch.telemetry.enable`); concurrent threads append finished
    spans under one lock. The open-span path is lock-free — ids come
    from an atomic counter and nesting state lives in a context var.
    """

    enabled = True

    def __init__(self, max_spans: int = 200_000, *, sample: float = 1.0,
                 seed: Optional[int] = None) -> None:
        if not 0.0 <= sample <= 1.0:
            raise ValueError("sample must be in [0.0, 1.0]")
        self.max_spans = max_spans
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self.dropped = 0
        self._id_lock = threading.Lock()
        self._next_id = 1
        # perf_counter -> wall-clock anchor for absolute-timeline export
        self.epoch_s = time.time() - time.perf_counter()
        self._hist: Dict[str, Any] = {}
        # head-based trace sampling: the keep/drop decision is made once
        # per root span; sampled_out counts dropped *traces* (descendant
        # spans of a dropped trace are no-ops and are not counted)
        self.sample = float(sample)
        self.sampled_out = 0
        self._rng = random.Random(seed)

    # -- id allocation -------------------------------------------------------
    def _alloc_id(self) -> int:
        with self._id_lock:
            i = self._next_id
            self._next_id += 1
            return i

    # -- span lifecycle ------------------------------------------------------
    def span(self, name: str, *, parent: Optional[SpanContext] = None,
             **attrs: Any) -> Span:
        """Open a span. Use as a context manager::

            with tracer.span("launch:bfs", mode="full") as sp:
                ...
                sp.set(edges=n)

        ``parent`` overrides the ambient (context-local) parent — the
        cross-thread handoff path. Without it, the innermost open span in
        this execution context is the parent; a parentless span roots a
        new trace.

        With ``sample < 1.0``, a would-be root span is kept with
        probability ``sample``; a dropped root returns a no-op that marks
        the context, so the *whole* trace (every descendant span) is
        dropped — summaries never see partial trees. Cross-thread work
        parented under a dropped root (its ``context()`` is None, so the
        handoff passes ``parent=None``) makes its own sampling decision.
        """
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            cur = _CURRENT.get()
            if cur is not None:
                if cur[0] < 0:  # inside a sampled-out trace
                    return NULL_SPAN
                trace_id, parent_id = cur
            else:
                if self.sample < 1.0 and self._rng.random() >= self.sample:
                    with self._lock:
                        self.sampled_out += 1
                    return _SampledOutSpan()
                trace_id, parent_id = None, None
        sid = self._alloc_id()
        if trace_id is None:
            trace_id = sid
        return Span(self, name, sid, trace_id, parent_id, attrs)

    def record_span(self, name: str, t_start: float, t_end: float, *,
                    parent: Optional[SpanContext] = None,
                    **attrs: Any) -> Span:
        """Record an already-timed interval (perf_counter seconds).

        For phases whose start predates knowing they are interesting —
        e.g. a request's queue wait is only measurable when the request
        leaves the queue, from its recorded submit time.
        """
        sp = self.span(name, parent=parent, **attrs)
        if not isinstance(sp, Span):  # sampled out / inside a dropped trace
            return sp
        sp.t_start = t_start
        sp.t_end = t_end
        self._finish(sp)
        return sp

    def current(self) -> Optional[SpanContext]:
        """The innermost open span's context (for cross-thread handoff).

        Inside a sampled-out trace this is None — handed-off work then
        roots its own trace and makes its own sampling decision."""
        cur = _CURRENT.get()
        if cur is None or cur[0] < 0:
            return None
        return SpanContext(*cur)

    def _finish(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(span)
            else:
                self.dropped += 1
            key = span.name if (
                span.name in self._hist or len(self._hist) < _MAX_HIST_NAMES
            ) else "other"
            h = self._hist.get(key)
            if h is None:
                h = self._hist[key] = _new_histogram()
            h.record(span.duration_s)

    # -- readout -------------------------------------------------------------
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._hist.clear()
            self.dropped = 0
            self.sampled_out = 0

    def histograms(self) -> Dict[str, Any]:
        """Merged copy of the per-span-name duration histograms."""
        with self._lock:
            return {k: _new_histogram().merge(h) for k, h in self._hist.items()}

    def summarize(self, root: Optional[SpanContext] = None) -> Dict[str, Any]:
        """Aggregate finished spans into a compact per-name summary.

        With ``root``, only the subtree under that span is summarized
        (the per-run ``EngineResult.trace`` path); without it, every
        retained span contributes. Returns ``{"spans": {name: {count,
        total_s, max_s}}, "total_s", "span_count", "dropped"}``.
        """
        spans = self.spans()
        if root is not None:
            keep = {root.span_id}
            grew = True
            by_parent: Dict[Optional[int], List[Span]] = {}
            for s in spans:
                by_parent.setdefault(s.parent_id, []).append(s)
            frontier = [root.span_id]
            while grew and frontier:
                grew = False
                nxt: List[int] = []
                for pid in frontier:
                    for s in by_parent.get(pid, ()):
                        if s.span_id not in keep:
                            keep.add(s.span_id)
                            nxt.append(s.span_id)
                            grew = True
                frontier = nxt
            spans = [s for s in spans if s.span_id in keep]
        agg: Dict[str, Dict[str, float]] = {}
        for s in spans:
            a = agg.setdefault(s.name, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            a["count"] += 1
            a["total_s"] += s.duration_s
            a["max_s"] = max(a["max_s"], s.duration_s)
        for a in agg.values():
            a["total_s"] = round(a["total_s"], 6)
            a["max_s"] = round(a["max_s"], 6)
        return {
            "spans": agg,
            "span_count": len(spans),
            "total_s": round(sum(a["total_s"] for a in agg.values()), 6),
            "dropped": self.dropped,
        }

    # -- exporters (delegate to repro_torch.telemetry.export) ----------------------
    def export_chrome(self, path: str) -> int:
        """Write retained spans as Chrome/Perfetto ``trace_event`` JSON;
        returns the number of duration events written."""
        from .export import export_chrome

        return export_chrome(self, path)

    def prometheus_text(self) -> str:
        """Prometheus-style text exposition of the span histograms."""
        from .export import prometheus_text

        return prometheus_text(self)


class NullTracer:
    """The disabled state: accepts the full Tracer API, retains nothing."""

    enabled = False
    dropped = 0
    epoch_s = 0.0

    def span(self, name: str, *, parent: Optional[SpanContext] = None,
             **attrs: Any) -> _NullSpan:
        return NULL_SPAN

    def record_span(self, name: str, t_start: float, t_end: float, *,
                    parent: Optional[SpanContext] = None,
                    **attrs: Any) -> _NullSpan:
        return NULL_SPAN

    def current(self) -> None:
        return None

    def spans(self) -> List[Span]:
        return []

    def reset(self) -> None:
        return None

    def histograms(self) -> Dict[str, Any]:
        return {}

    def summarize(self, root: Optional[SpanContext] = None) -> Dict[str, Any]:
        return {"spans": {}, "span_count": 0, "total_s": 0.0, "dropped": 0}

    def export_chrome(self, path: str) -> int:
        from .export import export_chrome

        return export_chrome(self, path)

    def prometheus_text(self) -> str:
        return ""


NULL_TRACER = NullTracer()
