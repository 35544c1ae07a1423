"""repro_torch.telemetry: end-to-end tracing from compile to serve.

The runtime's structured observability layer — the software analogue of
the per-stage hardware performance counters FPGA graph stacks tune
against. Spans cover the whole pipeline:

=============== ============================================= =========
span            where                                          attrs
=============== ============================================= =========
``compile``     :func:`repro_torch.compile` (front-end + passes) frontend, cache_hit, fingerprint
``lower``       ``Program.lower`` / ``Accelerator.__init__``   fingerprint, target, bucket
``bind``        ``Accelerator.bind``                           fingerprint, n_vertices, n_edges
``run``         one ``Engine``/``BatchEngine`` execution       launches, batch K
``launch:<k>``  one device-kernel launch                       mode, direction, frontier occupancy
``superstep``   one distributed shuffle superstep              kernel, devices, shuffle elements, edges
``update``      ``StreamingSession.update``                    n_added, program, version, rebucketed
``repair``      incremental recomputation of a cached result   program, from/to version, added_edges
``schedule``    ``GraphService.submit`` admission              tenant, program, fingerprint, tuned
``queue_wait``  submit -> scheduler pickup                     tenant, label
``batch_form``  scheduler fill-wait while forming a batch      tenant, batch K
``execute``     scheduler running a formed batch               tenant, label, batch K
``autotune``    one ``AutoTuner.tune`` search                  fingerprint, bucket, candidates, trials
=============== ============================================= =========

Usage::

    import repro_torch, repro_torch.telemetry as tel

    tracer = tel.enable()            # start recording (process-wide)
    result = repro_torch.compile(src).bind(graph).run(root=0)
    print(result.trace)              # per-run summary (hottest kernels)
    tracer.export_chrome("trace.json")   # load in Perfetto / chrome://tracing
    tel.disable()                    # back to the no-op null tracer

Tracing is **off by default**: the module-level tracer is a
:class:`~repro_torch.telemetry.tracer.NullTracer` whose spans are preallocated
no-ops, and instrumentation sites guard on ``tracer.enabled``: an
untraced launch costs one attribute check.

For always-on production use, ``tel.enable(sample=0.1)`` keeps ~10% of
traces (decided once per root span; kept traces stay complete).
"""
from __future__ import annotations

import threading
from typing import Any, Optional, Union

from .tracer import (  # noqa: F401 - re-exported API
    NULL_SPAN,
    NULL_TRACER,
    NullTracer,
    Span,
    SpanContext,
    Tracer,
)
from .export import chrome_events, export_chrome, prometheus_text  # noqa: F401

__all__ = [
    "Tracer",
    "NullTracer",
    "Span",
    "SpanContext",
    "enable",
    "disable",
    "enabled",
    "get",
    "span",
    "current",
    "export_chrome",
    "chrome_events",
    "prometheus_text",
]

_install_lock = threading.Lock()
_active: Union[Tracer, NullTracer] = NULL_TRACER


def enable(max_spans: int = 200_000, *, sample: Optional[float] = None,
           seed: Optional[int] = None) -> Tracer:
    """Install (or return) the process-wide recording tracer.

    Idempotent: a second ``enable()`` returns the already-active tracer
    (its retained spans intact) so independent layers can call it without
    clobbering each other.

    ``sample`` enables head-based trace sampling: each new *root* span is
    kept with probability ``sample`` (``enable(sample=0.1)`` records ~10%
    of traces); descendants follow their root's decision so kept traces
    stay complete. ``None`` (the default) leaves an already-active
    tracer's rate untouched and means "record everything" on first
    enable. ``seed`` makes the sampling sequence deterministic and only
    applies when the tracer is first created.
    """
    global _active
    with _install_lock:
        if not isinstance(_active, Tracer):
            _active = Tracer(max_spans=max_spans,
                             sample=1.0 if sample is None else sample,
                             seed=seed)
        elif sample is not None:
            if not 0.0 <= sample <= 1.0:
                raise ValueError(f"sample must be in [0, 1], got {sample!r}")
            _active.sample = float(sample)
        return _active


def disable() -> None:
    """Swap back to the null tracer and drop every retained span.

    After ``disable()`` the active tracer retains nothing: ``get().
    spans() == []`` and new spans are no-ops.
    """
    global _active
    with _install_lock:
        if isinstance(_active, Tracer):
            _active.reset()
        _active = NULL_TRACER


def get() -> Union[Tracer, NullTracer]:
    """The active tracer (never None; null tracer when disabled)."""
    return _active


def enabled() -> bool:
    return _active.enabled


def span(name: str, *, parent: Optional[SpanContext] = None, **attrs: Any):
    """Open a span on the active tracer (no-op context when disabled)."""
    return _active.span(name, parent=parent, **attrs)


def current() -> Optional[SpanContext]:
    """Context token of the innermost open span (cross-thread handoff)."""
    return _active.current()
