"""Artifact registry: bounded, fingerprint-keyed accelerator + session store.

The serving tier answers `submit(program, graph, **params)` for many
programs x shape buckets concurrently. This module owns the resolution
ladder behind that call:

1. **resident** — a live :class:`ResidentEntry` (bound Session + lazy
   BatchSession) for the exact (program, target, bucket, graph) already
   exists: reuse it, zero compile cost.
2. **warm artifact** — no resident entry, but the on-disk store (the
   port's own ``~/.cache/repro-torch-artifacts`` layout of ``save`` /
   :func:`~repro_torch.core.accelerator.load_accelerator`) holds the
   accelerator: load it and bind. Loading lowers again from the saved
   source, but finds the CUDA libraries built at the manifest's source
   hash, so no ``nvcc`` runs.
3. **cold compile** — lower a fresh :class:`Accelerator` and save it
   back best-effort.

Three serving-grade behaviors distinguish this from bare
:func:`~repro_torch.core.accelerator.load_or_lower`:

* **LRU eviction with pin counts** — at most ``max_resident`` live
  entries; eviction *defers* teardown until every in-flight query
  releases its pin, so a size-1 registry under churn never yanks device
  state out from under a running query.
* **single-flight lowering** — concurrent requests for the same
  (program, bucket, target) share ONE load-or-lower; followers block on
  the leader's flight instead of compiling N copies.
* **negative entries + quarantine** — a store path that failed its load
  check is renamed aside (:func:`~repro_torch.core.accelerator.
  quarantine_artifact`) and remembered for ``negative_ttl_s``; requests
  go straight to cold compile instead of re-probing the corrupt bytes
  on every miss (retry-storm guard). A successful fresh save clears the
  negative entry — the path holds known-good content again.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from ..core.accelerator import (
    Accelerator,
    GraphShape,
    accelerator_fingerprint,
    load_accelerator,
    quarantine_artifact,
)
from ..core.target import Target
from ..streaming.session import _RWGate
from .metrics import ServeMetrics

__all__ = ["ArtifactRegistry", "ResidentEntry", "default_artifact_dir"]


def default_artifact_dir() -> str:
    """The port's shared artifact store: ``$REPRO_TORCH_ARTIFACT_DIR``, else
    ``~/.cache/repro-torch-artifacts``. The port's artifacts are a format
    of their own (:data:`~repro_torch.core.accelerator.ARTIFACT_FORMAT`),
    so the store is never the reference package's."""
    return os.environ.get(
        "REPRO_TORCH_ARTIFACT_DIR", os.path.expanduser("~/.cache/repro-torch-artifacts")
    )


class _Flight:
    """One in-progress build that concurrent requesters wait on."""

    __slots__ = ("event", "value", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.value: Any = None
        self.error: Optional[BaseException] = None


class ResidentEntry:
    """A live binding: one accelerator bound to one graph, query-ready.

    Holds a :class:`~repro_torch.core.session.Session`: single queries run
    on it, grouped ones through its ``run_many(..., batched=True)``, whose
    batched twin shares the session's engine and lock, so the graph is
    bound on the device once for both. A readers-writer gate
    makes streaming graph updates (:meth:`update`) wait for in-flight
    queries and block new ones — every result carries the graph
    ``version`` it observed. Two scheduler workers reaching one entry take
    turns on the session lock; each launches on the session's device.

    Lifecycle is pin-counted: the registry pins an entry per in-flight
    request and :meth:`close` (LRU eviction, registry shutdown) only
    tears the sessions down once the last pin is released.
    """

    def __init__(self, key: Tuple, accelerator: Accelerator, graph,
                 *, max_batch: int = 16) -> None:
        self.key = key
        self.accelerator = accelerator
        self.graph = graph
        self.version = 0
        self.queries = 0
        self._max_batch = max_batch
        self._gate = _RWGate()
        self._lock = threading.Lock()
        self._refs = 0
        self._closed = False
        self._torn_down = False
        t0 = time.perf_counter()
        self.session = accelerator.bind(graph)
        self.bind_s = time.perf_counter() - t0  # the graph's one bind

    # -- pin counting --------------------------------------------------------
    def try_pin(self) -> bool:
        with self._lock:
            if self._closed:
                return False
            self._refs += 1
            return True

    def release(self) -> None:
        with self._lock:
            self._refs -= 1
            teardown = self._closed and self._refs == 0 and not self._torn_down
            if teardown:
                self._torn_down = True
        if teardown:
            self._teardown()

    def close(self) -> None:
        """Mark evicted; teardown happens when the last pin releases."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            teardown = self._refs == 0 and not self._torn_down
            if teardown:
                self._torn_down = True
        if teardown:
            self._teardown()

    def _teardown(self) -> None:
        self.session.close()  # closes the batched twin too

    # -- execution -----------------------------------------------------------
    def _on_device(self):
        """The session's CUDA device as current on this (worker) thread,
        so the kernels launch where the session's tensors live."""
        if self.session.device.startswith("cuda"):
            import torch

            return torch.cuda.device(self.session.device)
        return contextlib.nullcontext()

    def run(self, params: Dict[str, Any]):
        self._gate.acquire_read()
        try:
            with self._on_device():
                result = self.session.run(**params)
            result.version = self.version
            self.queries += 1
            return result
        finally:
            self._gate.release_read()

    def run_many(self, param_sets: List[Dict[str, Any]]):
        if len(param_sets) == 1:
            return [self.run(param_sets[0])]
        self._gate.acquire_read()
        try:
            with self._on_device():
                out = []
                for i in range(0, len(param_sets), self._max_batch):
                    out.extend(self.session.run_many(param_sets[i:i + self._max_batch],
                                                     batched=True))
            for r in out:
                r.version = self.version
            self.queries += len(param_sets)
            return out
        finally:
            self._gate.release_read()

    def update(self, delta) -> int:
        """Apply a graph delta in place and rebind; returns new version.

        Writer-priority: waits for in-flight queries, blocks new ones.
        The delta must fit the graph's padding slack
        (:meth:`GraphData.apply_updates` raises otherwise) — re-bucketing
        belongs to :class:`~repro_torch.streaming.StreamingSession`.
        """
        self._gate.acquire_write()
        try:
            self.graph.apply_updates(delta)
            with self._on_device():
                # re-points the batched twin, which shares the engine
                self.session.refresh_graph(self.graph)
            self.version += 1
            return self.version
        finally:
            self._gate.release_write()

    def __repr__(self) -> str:
        return (
            f"ResidentEntry({self.accelerator.fingerprint[:12]}, "
            f"v{self.version}, queries={self.queries})"
        )


class ArtifactRegistry:
    """Bounded resident-session + accelerator store over the artifact dir.

    ``acquire(program, graph, target)`` returns a **pinned**
    :class:`ResidentEntry`; the caller must :meth:`ResidentEntry.release`
    it after use. Accelerators (the expensive part) are cached separately
    from resident entries (the graph-bound part), so evicting a binding
    under ``max_resident`` pressure does not throw away its lowering.
    ``device`` is as for ``Program.bind``: ``None`` means ``"cuda"``.
    """

    def __init__(self, store_dir: Optional[str] = None, *,
                 max_resident: int = 8, max_accelerators: int = 32,
                 max_batch: int = 16, negative_ttl_s: float = 300.0,
                 metrics: Optional[ServeMetrics] = None,
                 device: Optional[str] = None) -> None:
        if max_resident < 1:
            raise ValueError("max_resident must be >= 1")
        if max_accelerators < 1:
            raise ValueError("max_accelerators must be >= 1")
        self.store_dir = store_dir
        # every accelerator and binding of this registry lives on one
        # device (None means "cuda", as for Program.bind); resolved at the
        # first lowering, so a registry without a GPU fails there
        self.device = device
        self.max_resident = max_resident
        self.max_accelerators = max_accelerators
        self.max_batch = max_batch
        self.negative_ttl_s = negative_ttl_s
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.lowerings = 0  # accelerators actually built (not loaded)
        self._lock = threading.Lock()
        self._residents: "OrderedDict[Tuple, ResidentEntry]" = OrderedDict()
        self._accelerators: "OrderedDict[str, Accelerator]" = OrderedDict()
        self._negative: Dict[str, float] = {}  # acc fingerprint -> expiry
        self._entry_flights: Dict[Tuple, _Flight] = {}
        self._acc_flights: Dict[str, _Flight] = {}
        self._closed = False

    # -- single-flight -------------------------------------------------------
    def _single_flight(self, table: Dict, key, build):
        """Run ``build`` once per key across concurrent callers.

        Returns ``(value, leader)``; followers observe the leader's value
        (or re-raise its exception) and are counted as shared builds.
        """
        with self._lock:
            flight = table.get(key)
            leader = flight is None
            if leader:
                flight = _Flight()
                table[key] = flight
        if not leader:
            flight.event.wait()
            self.metrics.registry_event("single_flight_shared")
            if flight.error is not None:
                raise flight.error
            return flight.value, False
        try:
            flight.value = build()
            return flight.value, True
        except BaseException as e:
            flight.error = e
            raise
        finally:
            flight.event.set()
            with self._lock:
                table.pop(key, None)

    # -- accelerator resolution (warm artifact vs cold compile) --------------
    def _negative_active(self, acc_key: str) -> bool:
        expiry = self._negative.get(acc_key)
        if expiry is None:
            return False
        if time.monotonic() >= expiry:
            self._negative.pop(acc_key, None)
            return False
        return True

    def _resolve_accelerator(self, acc_key: str, program, target: Target,
                             shape: GraphShape) -> Accelerator:
        path = (
            os.path.join(self.store_dir, acc_key[:24])
            if self.store_dir else None
        )
        if path and os.path.isdir(path):
            with self._lock:
                skip = self._negative_active(acc_key)
            if not skip:
                try:
                    acc = load_accelerator(path, device=self.device)
                    self.metrics.registry_event("artifact_hits")
                    return acc
                except Exception:
                    # corrupt/stale content: move it aside and remember,
                    # so the miss path is taken without re-probing
                    with self._lock:
                        self._negative[acc_key] = (
                            time.monotonic() + self.negative_ttl_s
                        )
                    quarantine_artifact(path)
                    self.metrics.registry_event("quarantined")
        acc = Accelerator(program, target, shape, device=self.device)
        with self._lock:
            self.lowerings += 1
        self.metrics.registry_event("cold_lowerings")
        if path:
            # unwritable store: cold result is still valid
            with contextlib.suppress(OSError):
                acc.save(path)
                with self._lock:
                    # the path holds known-good content again: let the
                    # next process warm-start from it
                    self._negative.pop(acc_key, None)
        return acc

    def _accelerator_for(self, program, target: Target,
                         shape: GraphShape) -> Accelerator:
        acc_key = accelerator_fingerprint(program.fingerprint, target, shape)
        with self._lock:
            acc = self._accelerators.get(acc_key)
            if acc is not None:
                self._accelerators.move_to_end(acc_key)
                return acc
        acc, _ = self._single_flight(
            self._acc_flights, acc_key,
            lambda: self._resolve_accelerator(acc_key, program, target, shape),
        )
        with self._lock:
            self._accelerators[acc_key] = acc
            self._accelerators.move_to_end(acc_key)
            while len(self._accelerators) > self.max_accelerators:
                self._accelerators.popitem(last=False)
        return acc

    # -- resident entries ----------------------------------------------------
    def _build_entry(self, key: Tuple, program, graph, target: Target,
                     shape: GraphShape) -> ResidentEntry:
        acc = self._accelerator_for(program, target, shape)
        entry = ResidentEntry(key, acc, graph, max_batch=self.max_batch)
        entry.try_pin()  # born pinned for the building request
        evicted: List[ResidentEntry] = []
        with self._lock:
            self._residents[key] = entry
            self._residents.move_to_end(key)
            while len(self._residents) > self.max_resident:
                _, old = self._residents.popitem(last=False)
                evicted.append(old)
        for old in evicted:
            old.close()  # deferred while pinned
            self.metrics.registry_event("evictions")
        return entry

    def acquire(self, program, graph, target: Target) -> ResidentEntry:
        """Pin and return the resident entry for (program, graph, target).

        Transparently resolves resident -> warm artifact -> cold compile.
        The entry is keyed on the *identity* of ``graph`` (the registry
        keeps a strong reference, so the id is stable while resident):
        two distinct same-shape graphs get two bindings over one shared
        accelerator. Callers must ``release()`` the entry when done.
        """
        if self._closed:
            raise RuntimeError("ArtifactRegistry is closed")
        shape = GraphShape.of(graph)
        key = (program.fingerprint, target, shape, id(graph))
        while True:
            with self._lock:
                entry = self._residents.get(key)
                if entry is not None:
                    if entry.try_pin():
                        self._residents.move_to_end(key)
                        self.metrics.registry_event("resident_hits")
                        return entry
                    self._residents.pop(key, None)  # closed husk
            built, leader = self._single_flight(
                self._entry_flights, key,
                lambda: self._build_entry(key, program, graph, target, shape),
            )
            if leader:
                return built  # born pinned
            if built.try_pin():
                return built
            # the shared entry was evicted (and fully closed) before this
            # follower could pin it — rebuild

    # -- introspection / lifecycle -------------------------------------------
    def info(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "store_dir": self.store_dir,
                "resident": len(self._residents),
                "max_resident": self.max_resident,
                "accelerators": len(self._accelerators),
                "max_accelerators": self.max_accelerators,
                "lowerings": self.lowerings,
                "negative_entries": len(self._negative),
            }

    def close(self) -> None:
        with self._lock:
            self._closed = True
            entries = list(self._residents.values())
            self._residents.clear()
            self._accelerators.clear()
        for e in entries:
            e.close()
