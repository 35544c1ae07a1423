"""Serving metrics: counters + latency histograms, exported as JSON.

One :class:`ServeMetrics` instance backs a :class:`~repro_torch.serving.service.
GraphService`. Everything is in-process and lock-protected — the serving
tier's observability contract is a *snapshot*, not a push pipeline:
``snapshot()`` returns a plain JSON-serializable dict with

* global and per-tenant / per-program query counters (submitted,
  completed, errors, overloaded rejections, deadline rejections,
  deadline misses, tuned-config hits) and latency percentiles,
* batch-formation accounting (batches, queries, occupancy against the
  scheduler's ``max_batch``),
* registry traffic (resident hits, warm artifact loads, cold lowerings,
  evictions, quarantined artifacts, single-flight shared builds).

Latency percentiles come from :class:`LatencyHistogram` (one copy, in
:mod:`repro_torch.telemetry.histogram`, shared with the tracer's per-span
durations) — fixed geometric buckets (no per-sample storage, bounded
memory for long-lived services); a reported percentile is the upper bound
of its bucket, so it errs pessimistic by at most the bucket ratio
(~1.35x).
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..telemetry.histogram import LatencyHistogram

__all__ = ["LatencyHistogram", "ServeMetrics"]

class _Group:
    """Counter bundle for one key (a tenant or a program label)."""

    __slots__ = (
        "submitted", "completed", "errors", "rejected_overloaded",
        "rejected_deadline", "rejections_analysis", "deadline_misses",
        "tuned_hits", "latency",
    )

    def __init__(self) -> None:
        self.submitted = 0
        self.completed = 0
        self.errors = 0
        self.rejected_overloaded = 0
        self.rejected_deadline = 0
        self.rejections_analysis = 0
        self.deadline_misses = 0
        self.tuned_hits = 0
        self.latency = LatencyHistogram()

    def snapshot(self) -> Dict[str, Any]:
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "errors": self.errors,
            "rejected_overloaded": self.rejected_overloaded,
            "rejected_deadline": self.rejected_deadline,
            "rejections_analysis": self.rejections_analysis,
            "deadline_misses": self.deadline_misses,
            "tuned_hits": self.tuned_hits,
            "latency_ms": self.latency.snapshot(),
        }


_REGISTRY_EVENTS = (
    "resident_hits",
    "artifact_hits",
    "cold_lowerings",
    "evictions",
    "quarantined",
    "single_flight_shared",
)


class ServeMetrics:
    """Thread-safe counters + histograms for one serving instance."""

    def __init__(self, max_batch: int = 1) -> None:
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self.max_batch = max_batch
        self._global = _Group()
        self._tenants: Dict[str, _Group] = {}
        self._programs: Dict[str, _Group] = {}
        self._batches = 0
        self._batched_queries = 0
        self._registry = {k: 0 for k in _REGISTRY_EVENTS}
        # filled by the service so snapshots carry instantaneous depth
        self.queue_depth_fn: Optional[Callable[[], int]] = None

    def _groups(self, tenant: str, label: str) -> List[_Group]:
        return [
            self._global,
            self._tenants.setdefault(tenant, _Group()),
            self._programs.setdefault(label, _Group()),
        ]

    # -- request path --------------------------------------------------------
    def submitted(self, tenant: str, label: str) -> None:
        with self._lock:
            for g in self._groups(tenant, label):
                g.submitted += 1

    def rejected(self, tenant: str, label: str, kind: str) -> None:
        """kind: 'overloaded' (queue full) | 'deadline' (expired in queue)
        | 'analysis' (static analysis rejected the program at admission)."""
        field = {
            "overloaded": "rejected_overloaded",
            "deadline": "rejected_deadline",
            "analysis": "rejections_analysis",
        }.get(kind, "rejected_deadline")
        with self._lock:
            for g in self._groups(tenant, label):
                setattr(g, field, getattr(g, field) + 1)

    def completed(self, tenant: str, label: str, latency_s: float,
                  deadline_missed: bool = False) -> None:
        with self._lock:
            for g in self._groups(tenant, label):
                g.completed += 1
                g.latency.record(latency_s)
                if deadline_missed:
                    g.deadline_misses += 1

    def error(self, tenant: str, label: str) -> None:
        with self._lock:
            for g in self._groups(tenant, label):
                g.errors += 1

    def tuned_hit(self, tenant: str, label: str) -> None:
        """A submission resolved its Target from the TuningCache."""
        with self._lock:
            for g in self._groups(tenant, label):
                g.tuned_hits += 1

    # -- batch formation -----------------------------------------------------
    def batch(self, size: int) -> None:
        with self._lock:
            self._batches += 1
            self._batched_queries += size

    # -- registry traffic ----------------------------------------------------
    def registry_event(self, kind: str, n: int = 1) -> None:
        if kind not in self._registry:
            raise ValueError(f"unknown registry event {kind!r}")
        with self._lock:
            self._registry[kind] += n

    # -- export --------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            occupancy = (
                self._batched_queries / (self._batches * self.max_batch)
                if self._batches and self.max_batch else 0.0
            )
            snap: Dict[str, Any] = {
                "uptime_s": round(time.monotonic() - self._t0, 3),
                "queries": self._global.snapshot(),
                "tenants": {t: g.snapshot() for t, g in self._tenants.items()},
                "programs": {p: g.snapshot() for p, g in self._programs.items()},
                "batches": {
                    "batches": self._batches,
                    "queries": self._batched_queries,
                    "max_batch": self.max_batch,
                    "occupancy": round(occupancy, 4),
                },
                "registry": dict(self._registry),
            }
        fn = self.queue_depth_fn
        snap["queue_depth"] = int(fn()) if fn is not None else 0
        return snap

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)
