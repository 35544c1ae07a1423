"""Trace exporters: Chrome ``trace_event`` JSON + Prometheus-style text.

Chrome export targets the (stable, documented) JSON Object Format that
both ``chrome://tracing`` and Perfetto load: complete events (``"ph":
"X"``) with microsecond ``ts``/``dur``, grouped by pid/tid, plus
``thread_name`` metadata events so lanes are labeled. Span attributes
ride in ``args`` and parent links are preserved as ``args.span_id`` /
``args.parent_id`` so a tree can be reconstructed from the file alone.

The Prometheus exposition is the pull-model twin (the reference's metric
names, so one dashboard reads both packages): per span name, ``repro_span_count``,
``repro_span_duration_seconds_sum`` / ``_max`` and bucket-derived
``quantile`` samples from the shared fixed-bucket histograms.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List

__all__ = ["export_chrome", "chrome_events", "prometheus_text"]


def _json_safe(v: Any) -> Any:
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return str(v)


def chrome_events(tracer) -> List[Dict[str, Any]]:
    """Retained spans as a ``traceEvents`` list (complete + metadata)."""
    pid = os.getpid()
    events: List[Dict[str, Any]] = []
    thread_names: Dict[int, str] = {}
    for s in tracer.spans():
        thread_names.setdefault(s.thread_id, s.thread_name)
        args = {k: _json_safe(v) for k, v in s.attrs.items()}
        args["span_id"] = s.span_id
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        args["trace_id"] = s.trace_id
        events.append({
            "name": s.name,
            "cat": s.name.split(":", 1)[0],
            "ph": "X",
            "ts": (tracer.epoch_s + s.t_start) * 1e6,
            "dur": s.duration_s * 1e6,
            "pid": pid,
            "tid": s.thread_id,
            "args": args,
        })
    for tid, tname in thread_names.items():
        events.append({
            "name": "thread_name",
            "ph": "M",
            "pid": pid,
            "tid": tid,
            "args": {"name": tname},
        })
    return events


def export_chrome(tracer, path: str) -> int:
    """Write ``{"traceEvents": [...]}`` JSON to ``path``.

    Returns the number of duration (``"ph": "X"``) events written. A
    disabled (null) tracer writes a valid empty trace — callers can
    unconditionally export at shutdown.
    """
    events = chrome_events(tracer)
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return sum(1 for e in events if e.get("ph") == "X")


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def prometheus_text(tracer) -> str:
    """Span histograms in the Prometheus text exposition format."""
    hists = tracer.histograms()
    if not hists:
        return ""
    lines = [
        "# TYPE repro_span_count counter",
        "# TYPE repro_span_duration_seconds summary",
    ]
    for name in sorted(hists):
        h = hists[name]
        label = f'span="{_escape_label(name)}"'
        lines.append(f"repro_span_count{{{label}}} {h.total}")
        lines.append(
            f"repro_span_duration_seconds_sum{{{label}}} {h.sum_s:.6f}"
        )
        lines.append(
            f"repro_span_duration_seconds_max{{{label}}} {h.max_s:.6f}"
        )
        for q in (50, 90, 99):
            lines.append(
                f'repro_span_duration_seconds{{{label},quantile="0.{q}"}} '
                f"{h.percentile(q):.6f}"
            )
    dropped = getattr(tracer, "dropped", 0)
    lines.append("# TYPE repro_spans_dropped counter")
    lines.append(f"repro_spans_dropped {dropped}")
    return "\n".join(lines) + "\n"
