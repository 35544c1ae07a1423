"""Versioned serving over a mutating graph: :class:`StreamingSession`.

The port of the reference's ``streaming/session.py``. A StreamingSession
wraps the ordinary serving surface (:class:`Session` or
:class:`SessionPool`) with a monotonically increasing *graph version*:

- ``update(delta)`` applies a :class:`~repro_torch.graph.storage.GraphDelta`
  **in place** via :meth:`GraphData.apply_updates` — the physical buffer
  shapes never change, so rebinding the engines re-derives the graph's
  bindings with zero re-lowering (the kernel library is shape-generic) —
  then bumps the version. If the delta
  overflows the padding slack, the graph is transparently re-bucketed
  (:meth:`GraphShape.bucket_for`) and the serving surface rebuilt.
- ``run()``/``submit()`` pin every admitted query to the version current at
  admission; results carry ``result.version`` and concurrent updates wait
  for in-flight queries (a readers-writer gate with writer priority), so a
  query never observes a torn half-updated graph.
- Results are cached per parameter binding. A cache hit at the current
  version is free; a hit at an older version is *incrementally repaired*
  (:mod:`repro_torch.streaming.incremental`) when the program is monotone
  (min=/max= reductions only — BFS/SSSP/CC) and every pending delta is
  additions-only, and falls back to a full re-run otherwise (PageRank-class
  programs always take the full path).

On the GPU every full run launches the hand-written ``shuffle_reduce`` and
``edge_stream`` kernels through the refreshed bindings (their work lists
rebuilt from the updated dst offsets); a repair is numpy on the host.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.accelerator import Accelerator, GraphShape
from ..core.engine import EngineResult
from ..core.session import resolve_device
from ..core.target import Target
from ..core.passes import analyze_incremental
from ..graph.storage import GraphData, GraphDelta, GraphUpdateError
from .incremental import repair_result
from .. import telemetry as tel

__all__ = ["StreamingSession"]


class _RWGate:
    """Readers-writer lock with writer priority.

    Queries hold read slots (possibly across threads: ``submit`` acquires on
    the caller thread and releases when the Future resolves); ``update``
    takes the write side. A waiting writer blocks *new* readers so a steady
    query stream cannot starve updates.
    """

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
                self._writer = True
            finally:
                self._writers_waiting -= 1

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()


class StreamingSession:
    """Serve queries over a graph that receives streaming edge updates.

    Parameters
    ----------
    program / graph
        The compiled program and the (padded) graph to serve. ``graph``
        must carry padding slack (``pad_to`` a bucket, e.g. via
        ``GraphShape.bucket_for``) for in-place updates to land in.
    backend
        ``"local"`` (one device) or ``"distributed"``: the latter binds
        ``Target(kind="distributed")`` (or the given ``target`` with that
        kind), whose engine runs edge kernels as shuffle supersteps across
        the target's shard devices.
    accelerator
        Optional :class:`Accelerator` to bind instead of binding through
        ``program``; in-bucket updates keep its kernels warm
        (``stats.compile_time_s == 0`` after warm-up).
    target / device
        As for ``program.bind`` when no accelerator is given (``device=None``
        means ``"cuda"``); an accelerator brings its own.
    pool_size / batch
        ``pool_size >= 1`` serves through a :class:`SessionPool` (enabling
        :meth:`submit`); ``batch > 1`` additionally turns on dynamic
        batching inside the pool.
    """

    def __init__(
        self,
        program,
        graph: GraphData,
        backend: str = "local",
        *,
        accelerator: Optional[Accelerator] = None,
        pool_size: int = 0,
        batch: int = 0,
        cache_results: bool = True,
        cache_size: int = 256,
        compact_every: int = 64,
        delta_log: int = 256,
        argv: Optional[list] = None,
        target: Optional[Target] = None,
        device: Optional[str] = None,
    ) -> None:
        if backend not in ("local", "distributed"):
            raise ValueError(f"unknown StreamingSession backend {backend!r}; "
                             "expected 'local' or 'distributed'")
        if accelerator is not None:
            program = accelerator.program
            target, device = accelerator.target, accelerator.device
        elif backend == "distributed" and (target is None or target.kind != "distributed"):
            target = dataclasses.replace(target or Target(), kind="distributed")
        self.program = program
        self.graph = graph
        self.backend = backend if accelerator is None else accelerator.target.kind
        self.target = target
        self.device = resolve_device(device)
        self.version = 0
        self.cache_results = cache_results
        self.cache_size = cache_size
        self.compact_every = compact_every
        self._accelerator = accelerator
        self._pool_size = pool_size
        self._batch = batch
        self._argv = argv
        self._gate = _RWGate()
        self._cache_lock = threading.Lock()
        self._info = None  # lazy analyze_incremental verdict
        self._results: "OrderedDict[Tuple, Tuple[int, EngineResult]]" = OrderedDict()
        # (version, delta) per update; None delta marks a non-repairable
        # event (re-bucketing replaced the physical arrays).
        self._deltas: "deque[Tuple[int, Optional[GraphDelta]]]" = deque(
            maxlen=delta_log
        )
        self.session = None
        self.pool = None
        self._build_sessions()

        # observability
        self.updates = 0
        self.rebuckets = 0
        self.cache_hits = 0
        self.incremental_runs = 0
        self.full_runs = 0
        self.update_apply_s: List[float] = []
        # where an update's time goes: the graph's own update (apply_updates,
        # compaction or a re-bucket) and the serving surface's refresh_graph
        self.update_graph_s: List[float] = []
        self.update_refresh_s: List[float] = []

    # -- construction --------------------------------------------------------
    def _build_sessions(self) -> None:
        if self.session is not None:
            self.session.close()
        if self.pool is not None:
            self.pool.close()
        acc = self._accelerator
        if self._pool_size >= 1:
            if acc is not None:
                self.pool = acc.pool(
                    self.graph, size=self._pool_size, argv=self._argv, batch=self._batch
                )
            else:
                self.pool = self.program.pool(
                    self.graph, size=self._pool_size, target=self.target,
                    device=self.device, argv=self._argv, batch=self._batch,
                )
            self.session = None
        else:
            if acc is not None:
                self.session = acc.bind(self.graph, argv=self._argv)
            else:
                self.session = self.program.bind(
                    self.graph, target=self.target, device=self.device, argv=self._argv,
                )
            self.pool = None

    @property
    def incremental_info(self):
        """The monotonicity verdict for this program (lazy, cached)."""
        if self._info is None:
            self._info = analyze_incremental(self.program.module)
        return self._info

    # -- update path ---------------------------------------------------------
    def update(self, delta: GraphDelta) -> int:
        """Apply ``delta``, rebind the serving surface, bump the version.

        Blocks until in-flight queries drain (writer-priority gate), so no
        query ever runs against a half-applied graph. Returns the new
        version. In-bucket updates are shape-check-only rebinds; a delta
        that overflows the padding slack triggers a transparent re-bucket
        (new lowering unless an artifact for the new bucket is cached).
        """
        t0 = time.perf_counter()
        tr = tel.get()
        sp = tr.span(
            "update", n_added=delta.n_added, program=self.program.fingerprint[:16],
        ) if tr.enabled else tel.NULL_SPAN
        self._gate.acquire_write()
        try:
            with sp:
                t_graph = time.perf_counter()
                rebucketed = False
                try:
                    self.graph.apply_updates(delta)
                except GraphUpdateError:
                    self._rebucket(delta)
                    rebucketed = True
                self.updates += 1
                if (
                    not rebucketed
                    and self.compact_every
                    and self.updates % self.compact_every == 0
                ):
                    self.graph.compact()
                t1 = time.perf_counter()
                target = self.pool if self.pool is not None else self.session
                target.refresh_graph(self.graph)
                self.update_graph_s.append(t1 - t_graph)
                self.update_refresh_s.append(time.perf_counter() - t1)
                self.version += 1
                self._deltas.append((self.version, None if rebucketed else delta))
                sp.set(version=self.version, rebucketed=rebucketed)
                return self.version
        finally:
            self._gate.release_write()
            self.update_apply_s.append(time.perf_counter() - t0)

    def _rebucket(self, delta: GraphDelta) -> None:
        """Grow into a fresh geometric bucket and replay ``delta`` there."""
        g = self.graph
        real = ~g._free_slot_mask()
        base = GraphData(
            n_vertices=g.n_vertices_logical,
            src=np.asarray(g.src[real][: g.n_edges_logical]),
            dst=np.asarray(g.dst[real][: g.n_edges_logical]),
            weights=(
                np.asarray(g.weights[real][: g.n_edges_logical])
                if g.weights is not None
                else None
            ),
        )
        shape = GraphShape.bucket_for(
            base.n_vertices, base.n_edges + delta.n_added, weighted=g.weighted
        )
        padded = base.pad_to(shape.n_vertices, shape.n_edges)
        padded.apply_updates(delta)
        self.graph = padded
        if self._accelerator is not None:
            # the old artifact is pinned to the old bucket; lower a new one
            self._accelerator = self.program.lower(
                self._accelerator.target, shape, device=self.device
            )
        self._build_sessions()
        self.rebuckets += 1

    # -- query path ----------------------------------------------------------
    def run(self, **params) -> EngineResult:
        """Answer one query at the current graph version (synchronous)."""
        coerced = self.program.validate_params(params)
        key = tuple(sorted(coerced.items()))
        self._gate.acquire_read()
        try:
            served = self._serve_cached(key)
            if served is not None:
                return served
            result = self._run_full(coerced)
            result.version = self.version
            self._store(key, result)
            return result
        finally:
            self._gate.release_read()

    def submit(self, **params) -> "Future[EngineResult]":
        """Async :meth:`run`; requires ``pool_size >= 1`` for true async.

        The read slot taken at admission is held until the Future resolves,
        pinning the query to the version it was admitted under even while
        an :meth:`update` is waiting.
        """
        coerced = self.program.validate_params(params)
        key = tuple(sorted(coerced.items()))
        self._gate.acquire_read()
        try:
            served = self._serve_cached(key)
            if served is None and self.pool is None:
                served = self._run_full(coerced)
                served.version = self.version
                self._store(key, served)
            if served is not None:
                out: "Future[EngineResult]" = Future()
                out.set_result(served)
                self._gate.release_read()
                return out
        except BaseException:
            self._gate.release_read()
            raise
        version = self.version
        out = Future()

        def _resolve(inner: "Future[EngineResult]") -> None:
            try:
                result = inner.result()
            except BaseException as exc:
                self._gate.release_read()
                out.set_exception(exc)
                return
            result.version = version
            self.full_runs += 1
            self._store(key, result, version=version)
            self._gate.release_read()
            out.set_result(result)

        try:
            self.pool.submit(**coerced).add_done_callback(_resolve)
        except BaseException:
            self._gate.release_read()
            raise
        return out

    def warmup(self, **params) -> None:
        """Pre-touch every kernel (all pool workers when pooled)."""
        self._gate.acquire_read()
        try:
            if self.pool is not None:
                self.pool.warmup(**params)
            else:
                coerced = self.program.validate_params(params)
                result = self.session.run(**coerced)
                result.version = self.version
                self._store(tuple(sorted(coerced.items())), result)
        finally:
            self._gate.release_read()

    # -- internals -----------------------------------------------------------
    def _serve_cached(self, key: Tuple) -> Optional[EngineResult]:
        """Current-version cache hit, or an incremental repair of an older
        cached result; None when a full run is required."""
        if not self.cache_results:
            return None
        hit = self._results.get(key)
        if hit is None:
            return None
        cached_version, cached = hit
        if cached_version == self.version:
            self.cache_hits += 1
            self._results.move_to_end(key)
            return cached
        added = self._added_since(cached_version)
        if added is None:
            return None
        tr = tel.get()
        sp = tr.span(
            "repair", program=self.program.fingerprint[:16],
            from_version=cached_version, to_version=self.version,
            added_edges=int(len(added)),
        ) if tr.enabled else tel.NULL_SPAN
        with sp:
            result = repair_result(
                self.incremental_info, self.graph, cached, added,
                version=self.version, lane_ids=self._lane_ids(),
            )
        self.incremental_runs += 1
        self._store(key, result)
        return result

    def _lane_ids(self) -> Optional[np.ndarray]:
        """Original vertex id -> the id the program sees: the serving
        engines' hub relabel after their refresh (one map for every worker
        of a pool), None when they do not relabel."""
        sess = self.session if self.session is not None else self.pool._sessions[0]
        return sess.engine.old2new

    def _added_since(self, version: int) -> Optional[np.ndarray]:
        """Concatenated additions between ``version`` and now, or None when
        the window is not repairable (non-monotone program, trimmed log,
        re-bucket event, or any removal in the window)."""
        if not self.incremental_info.incremental_ok:
            return None
        window = [d for v, d in self._deltas if v > version]
        if len(window) != self.version - version:
            return None  # log trimmed: cannot reconstruct the delta chain
        if any(d is None or not d.additions_only for d in window):
            return None
        if not window:
            return np.zeros((0, 2), dtype=np.int64)
        return np.concatenate([d.added_edges for d in window]).astype(np.int64)

    def _run_full(self, coerced: Dict[str, Any]) -> EngineResult:
        self.full_runs += 1
        if self.pool is not None:
            return self.pool.submit(**coerced).result()
        return self.session.run(**coerced)

    def _store(self, key: Tuple, result: EngineResult,
               version: Optional[int] = None) -> None:
        if not self.cache_results:
            return
        v = self.version if version is None else version
        with self._cache_lock:
            existing = self._results.get(key)
            if existing is not None and existing[0] > v:
                return  # never clobber a newer-version result
            self._results[key] = (v, result)
            self._results.move_to_end(key)
            while len(self._results) > self.cache_size:
                self._results.popitem(last=False)

    # -- lifecycle -----------------------------------------------------------
    @property
    def batch_stats(self):
        return self.pool.batch_stats if self.pool is not None else None

    def close(self) -> None:
        if self.pool is not None:
            self.pool.close()
        if self.session is not None:
            self.session.close()

    def __enter__(self) -> "StreamingSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
