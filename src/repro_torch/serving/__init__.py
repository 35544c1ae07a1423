"""Serving tier: multi-tenant artifact registry + async SLO scheduler.

One entry point — ``repro_torch.serve(registry_dir)`` -> :class:`GraphService`
— over three layers:

* :mod:`repro_torch.serving.registry` — :class:`ArtifactRegistry`: bounded,
  fingerprint-keyed resident sessions + accelerators over the on-disk
  artifact store; LRU eviction with pin-safe teardown, single-flight
  lowering, quarantine + negative entries against stale-artifact retry
  storms.
* :mod:`repro_torch.serving.scheduler` — :class:`RequestScheduler`: bounded
  per-tenant queues with typed :class:`Overloaded` shedding, weighted
  fairness, per-request deadlines propagated into batch formation.
* :mod:`repro_torch.serving.metrics` — :class:`ServeMetrics`: per-tenant /
  per-program counters and latency histograms exported as JSON
  snapshots (``service.stats()``).
"""
from .metrics import LatencyHistogram, ServeMetrics
from .registry import ArtifactRegistry, ResidentEntry, default_artifact_dir
from .scheduler import (
    DeadlineExceeded,
    Overloaded,
    RequestScheduler,
    ServingError,
)
from .service import (
    GraphService,
    NAMED_ALGORITHMS,
    ProgramRejected,
    default_service,
    reset_default_service,
    run,
    serve,
)

__all__ = [
    "ArtifactRegistry",
    "DeadlineExceeded",
    "GraphService",
    "LatencyHistogram",
    "NAMED_ALGORITHMS",
    "Overloaded",
    "ProgramRejected",
    "RequestScheduler",
    "ResidentEntry",
    "ServeMetrics",
    "ServingError",
    "default_artifact_dir",
    "default_service",
    "reset_default_service",
    "run",
    "serve",
]
