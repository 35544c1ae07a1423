"""Sessions: a bound (program, graph, device) triple you run many times.

    session = program.bind(graph)          # device="cuda" by default
    result = session.run(root=3)
    results = session.run_many([{"root": 3}, {"root": 9}])  # one batch

``run(**params)`` validates the keyword parameters against the program's
declared host scalars, resets device/host state (keeping lowered kernels
and the graph bindings on the device), applies the parameters, and
executes.

Batched queries (the reference's surface, less its backend registry):
:class:`BatchSession` (``program.bind_batch``) answers a list of parameter
sets with one set of launches; ``Session.run_many`` and
``SessionPool.run_batch`` reroute batch-eligible lists to one; and
:class:`SessionPool` (``program.pool``) serves concurrent queries, with an
optional dynamic batcher. Every result is bit-identical to a sequential
``run`` of the same parameters.

Sessions bound from an :class:`~.accelerator.Accelerator` (``library=``)
launch its kernel library, and a traced run feeds the accelerator's
profiling baseline (``Accelerator.record_profile``).
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import torch

from .engine import Engine, EngineResult
from .program import Program
from .target import Target


class SessionError(Exception):
    pass


class ServiceClosed(SessionError):
    """Raised when submitting to a closed pool or batcher."""


# chunk size of the implicit BatchSessions behind Session.run_many and
# SessionPool.run_batch; explicit bind_batch() callers pick their own
AUTO_MAX_BATCH = 64


def resolve_device(device: Optional[str]) -> str:
    """``None`` means ``"cuda"``; a CUDA device must exist. Nothing falls
    back to the CPU: a caller who wants the CPU asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SessionError(
                "no CUDA device is available; device='cpu' runs the plain "
                "PyTorch versions of the kernels on the CPU"
            )
        return str(dev)
    if dev.type != "cpu":
        raise SessionError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return "cpu"


def make_engine(program: Program, graph, target: Target, device: str,
                argv: Optional[list], library=None) -> Engine:
    """The engine a target places a program on: the multi-device
    :class:`~.dist_engine.DistEngine` for ``kind == "distributed"``, the
    one-device :class:`~.engine.Engine` otherwise."""
    if target.kind == "distributed":
        from .dist_engine import DistEngine

        return DistEngine(program.module, graph, target, device, argv=argv, library=library)
    return Engine(program.module, graph, target, device, argv=argv, library=library)


def batch_eligible(coerced_sets: Sequence[Dict[str, Any]]) -> bool:
    """True when a list of validated parameter sets can share one batch:
    every set binds the SAME parameter names (the values are scalars by
    construction), so one batched state layout fits all of them."""
    if not coerced_sets:
        return False
    keys = set(coerced_sets[0])
    return all(set(p) == keys for p in coerced_sets[1:])


class Session:
    """One program bound to one graph on one device; run it many times.
    A distributed ``target`` binds the multi-device engine, its shards on
    ``target.mesh(device)``."""

    def __init__(self, program: Program, graph, *, target: Optional[Target] = None,
                 device: Optional[str] = None, argv: Optional[list] = None, library=None):
        self.program = program
        self.graph = graph
        self.device = resolve_device(device)
        self.target = target if target is not None else Target()
        argv = list(argv) if argv is not None else ["prog", "<graph>"]
        self.engine = make_engine(program, graph, self.target, self.device, argv, library)
        self.runs = 0
        # set by Accelerator.bind: traced runs feed its profiling baseline
        self.accelerator = None
        self._lock = threading.Lock()
        self._batch_session: Optional["BatchSession"] = None

    def run(self, **params) -> EngineResult:
        """Execute the bound program with explicit run-time parameters."""
        coerced = self.program.validate_params(params)
        with self._lock:  # a Session is a stateful device context
            self.engine.reset()
            self.engine.host_env.update(coerced)
            result = self.engine.run()
            self.runs += 1
        if result.trace is not None and self.accelerator is not None:
            self.accelerator.record_profile(result.trace)
        return result

    def run_many(self, param_sets: Sequence[Dict[str, Any]],
                 batched: Optional[bool] = None) -> List[EngineResult]:
        """Run a sequence of parameter sets; results in submission order.

        ``run_many(ps)[i]`` carries properties and host scalars
        bit-identical to ``run(**ps[i])``. Two or more batch-eligible sets
        (one parameter key set) are answered by one batched execution
        (:class:`BatchSession`, chunks of :data:`AUTO_MAX_BATCH`), whose
        results share one stats object with ``batch_size == K``; anything
        else runs the sequential loop. ``batched=True`` forces the batch
        (raising if ineligible), ``batched=False`` the loop.
        """
        sets = [dict(p) for p in param_sets]
        if batched is None:
            coerced = [self.program.validate_params(p) for p in sets]
            batched = len(sets) > 1 and batch_eligible(coerced)
        if batched:
            return self._ensure_batch_session().run_many(sets)
        return [self.run(**p) for p in sets]

    def refresh_graph(self, graph=None) -> None:
        """Rebind after an in-place graph mutation (the streaming update
        path).

        Re-derives the engine's graph-dependent bindings (hub relabel,
        processing order, CSR/CSC device arrays, degree and weight
        buffers) against the updated graph of the same bucket, and
        re-points the batched twin, which shares the engine. The caller
        must guarantee no query is in flight (the
        :class:`~repro_torch.streaming.StreamingSession` write gate does);
        the session lock is still taken as a second line of defense
        against torn reads.
        """
        graph = graph if graph is not None else self.graph
        with self._lock:
            self.graph = graph
            self.engine.refresh_graph(graph)
            if self._batch_session is not None:
                self._batch_session._follow(graph)

    def _ensure_batch_session(self) -> "BatchSession":
        """The batched twin of this session, built on first use over this
        session's engine (the graph stays bound on the device once)."""
        with self._lock:
            if self._batch_session is None:
                self._batch_session = BatchSession(self.program, self.graph, session=self,
                                                   max_batch=AUTO_MAX_BATCH)
                # traced batched runs feed the profile, as this session's do
                self._batch_session.accelerator = self.accelerator
            return self._batch_session

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Release the session (and its batched twin)."""
        if self._batch_session is not None:
            self._batch_session.close()

    def __repr__(self) -> str:
        return (f"Session(on {self.device}, |V|={getattr(self.graph, 'n_vertices', '?')}, "
                f"runs={self.runs})")


class BatchSession:
    """One program bound to one graph, answering K queries per launch set.

    Created by ``program.bind_batch(graph, target=..., device=...)``.
    ``run_many`` takes parameter sets that share one key set and runs them
    as one batch (:class:`~repro_torch.batch.BatchEngine`): state gains a
    leading batch axis, host control flow runs with per-query masks, and
    BFS-like programs take the bit-packed multi-source path. Results are
    bit-identical to sequential :meth:`Session.run` calls, in submission
    order. ``max_batch`` chunks longer lists; ``msbfs=False`` turns the
    multi-source BFS path off (the generic batched path then serves BFS).
    Given ``session`` (what ``Session.run_many`` and ``SessionPool`` pass),
    it runs on that session's engine, under that session's lock, so the
    graph is bound on the device once.
    """

    def __init__(self, program: Program, graph, *, target: Optional[Target] = None,
                 device: Optional[str] = None, argv: Optional[list] = None,
                 max_batch: Optional[int] = None, msbfs: bool = True,
                 session: Optional[Session] = None, library=None):
        if max_batch is not None and max_batch < 1:
            raise SessionError("max_batch must be >= 1")
        from ..batch.engine import BatchEngine

        self.program = program
        self.graph = graph
        self._session = session
        if session is not None:
            self.device, self.target = session.device, session.target
            inner, self._lock = session.engine, session._lock
        else:
            self.device = resolve_device(device)
            self.target = target if target is not None else Target()
            argv = list(argv) if argv is not None else ["prog", "<graph>"]
            inner = make_engine(program, graph, self.target, self.device, argv, library)
            self._lock = threading.Lock()
        self.engine = BatchEngine(inner, enable_msbfs=msbfs)
        self.max_batch = max_batch
        self.runs = 0
        self.queries = 0
        # set by Accelerator.bind_batch: traced runs feed its profile
        self.accelerator = None

    def run_many(self, param_sets: Sequence[Dict[str, Any]]) -> List[EngineResult]:
        """Answer every parameter set in one (or, past ``max_batch``, a few)
        batched executions. All sets must share one parameter key set
        (:meth:`Session.run_many` handles mixed lists)."""
        coerced = [self.program.validate_params(dict(p)) for p in param_sets]
        if not coerced:
            return []
        if not batch_eligible(coerced):
            raise SessionError(
                "param sets are not batch-eligible: every set must bind the "
                "same parameter names (Session.run_many handles mixed streams)"
            )
        step = self.max_batch or len(coerced)
        out: List[EngineResult] = []
        with self._lock:  # one device context (shared with the wrapped session)
            for i in range(0, len(coerced), step):
                chunk = coerced[i:i + step]
                out.extend(self.engine.run_batch(chunk))
                self.runs += 1
                self.queries += len(chunk)
        if self.accelerator is not None:
            # one summary per chunk, shared by the chunk's results
            for trace in {id(r.trace): r.trace for r in out if r.trace is not None}.values():
                self.accelerator.record_profile(trace)
        return out

    def refresh_graph(self, graph=None) -> None:
        """Rebind after an in-place graph mutation (see
        :meth:`Session.refresh_graph`). A batch session over a session's
        engine refreshes that session, which owns the engine."""
        graph = graph if graph is not None else self.graph
        if self._session is not None:
            self._session.refresh_graph(graph)
        with self._lock:
            if self._session is None:
                self.engine.engine.refresh_graph(graph)
            self._follow(graph)

    def _follow(self, graph) -> None:
        """Re-point at the inner engine's refreshed graph (the caller holds
        the lock)."""
        self.graph = graph
        self.engine.refresh_graph()

    def __enter__(self) -> "BatchSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Release the session (a hook, as on the reference's surface)."""

    def __repr__(self) -> str:
        return (f"BatchSession(on {self.device}, "
                f"|V|={getattr(self.graph, 'n_vertices', '?')}, runs={self.runs}, "
                f"queries={self.queries})")


class SessionPool:
    """``size`` worker sessions over one (program, graph, device).

    Each worker owns its own session (device state and bound graph), so
    queries run concurrently. ``submit`` returns a Future; ``run_batch``
    keeps submission order. ``batch=N`` (N > 1) turns on dynamic batching:
    submitted queries are collected by a
    :class:`~repro_torch.batch.DynamicBatcher` into groups of up to N
    (waiting ``batch_wait_s`` for stragglers) and answered by one shared
    :class:`BatchSession` over the first worker's engine, with the same
    results and the same Futures;
    ``batch_stats`` then reports batch occupancy.
    """

    def __init__(self, program: Program, graph, size: int = 2, *,
                 target: Optional[Target] = None, device: Optional[str] = None,
                 argv: Optional[list] = None, batch: int = 0, batch_wait_s: float = 0.002,
                 library=None):
        if size < 1:
            raise SessionError("SessionPool size must be >= 1")
        self.program = program
        self.graph = graph
        self.size = size
        self.device = resolve_device(device)
        self.target = target
        self._sessions = [Session(program, graph, target=target, device=self.device, argv=argv,
                                  library=library)
                          for _ in range(size)]
        self._idle: List[Session] = list(self._sessions)
        self._idle_ready = threading.Condition(threading.Lock())
        self._executor = ThreadPoolExecutor(max_workers=size,
                                            thread_name_prefix="repro-torch-session")
        self._closed = False
        self._batch_session: Optional[BatchSession] = None
        self._batch_lock = threading.Lock()
        self._batcher = None
        if batch > 1:
            from ..batch.dynamic import DynamicBatcher

            bs = self._ensure_batch_session(max_batch=batch)
            self._batcher = DynamicBatcher(bs.run_many, max_batch=batch,
                                           max_wait_s=batch_wait_s)

    @property
    def batch_stats(self):
        """Dynamic-batching occupancy stats (None unless ``batch > 1``)."""
        return self._batcher.stats if self._batcher is not None else None

    def _ensure_batch_session(self, max_batch: Optional[int] = None) -> BatchSession:
        """The pool-shared BatchSession, built on first use over the first
        worker's engine (taking its lock while a batch runs)."""
        with self._batch_lock:
            if self._batch_session is None:
                self._batch_session = BatchSession(
                    self.program, self.graph, session=self._sessions[0],
                    max_batch=max_batch or AUTO_MAX_BATCH)
            return self._batch_session

    # -- scheduling ---------------------------------------------------------
    def _acquire(self) -> Session:
        with self._idle_ready:
            while not self._idle:
                self._idle_ready.wait()
            return self._idle.pop()

    def _release(self, sess: Session) -> None:
        with self._idle_ready:
            self._idle.append(sess)
            self._idle_ready.notify()

    def _run_one(self, params: Dict[str, Any]) -> EngineResult:
        sess = self._acquire()
        try:
            return sess.run(**params)
        finally:
            self._release(sess)

    # -- public API ---------------------------------------------------------
    def warmup(self, **params) -> None:
        """Run one query on every worker session (each builds and loads
        what its first launches need), and, with dynamic batching on, one
        full ``batch``-sized list on the shared BatchSession."""
        if self._closed:
            raise ServiceClosed("SessionPool is closed")
        self.program.validate_params(params)
        futures = [self._executor.submit(s.run, **params) for s in self._sessions]
        for f in futures:
            f.result()
        if self._batcher is not None:
            self._batch_session.run_many([dict(params)] * self._batcher.max_batch)

    def submit(self, **params) -> "Future[EngineResult]":
        """Enqueue one parameterized query, get a Future that resolves to the
        result a dedicated :meth:`Session.run` would give. With dynamic
        batching on, the query joins the collector queue; otherwise it goes
        to the next idle worker session."""
        if self._closed:
            raise ServiceClosed("SessionPool is closed")
        self.program.validate_params(params)  # fail fast on the caller thread
        if self._batcher is not None:
            return self._batcher.submit(params)
        try:
            return self._executor.submit(self._run_one, params)
        except RuntimeError as e:
            # close() raced this submit: the executor rejects with a raw
            # RuntimeError("cannot schedule new futures after shutdown")
            raise ServiceClosed("SessionPool is closed") from e

    def refresh_graph(self, graph=None) -> None:
        """Rebind every worker (and the shared BatchSession) after an
        in-place graph mutation. The pool must be quiescent (no query in
        flight): the dynamic batcher is drained first, and the streaming
        layer's write gate keeps new queries out; callers driving the pool
        directly must arrange the same.
        """
        if self._closed:
            raise ServiceClosed("SessionPool is closed")
        graph = graph if graph is not None else self.graph
        self.graph = graph
        if self._batcher is not None:
            self._batcher.drain()
        for s in self._sessions:
            s.refresh_graph(graph)
        if self._batch_session is not None:
            with self._batch_session._lock:
                self._batch_session._follow(graph)

    def run_batch(self, param_sets: Sequence[Dict[str, Any]],
                  batched: Optional[bool] = None) -> List[EngineResult]:
        """Run every parameter set; results in submission order, each
        identical to one :meth:`Session.run`. Batch-eligible lists (two or
        more sets, one key set) go through the pool's shared
        :class:`BatchSession`; anything else fans out to the workers.
        ``batched=True``/``False`` forces the choice (True raises on an
        ineligible list)."""
        if self._closed:
            raise ServiceClosed("SessionPool is closed")
        sets = [dict(p) for p in param_sets]
        if batched is None:
            coerced = [self.program.validate_params(p) for p in sets]
            batched = len(sets) > 1 and batch_eligible(coerced)
        if batched:
            return self._ensure_batch_session().run_many(sets)
        futures = [self.submit(**p) for p in sets]
        return [f.result() for f in futures]

    def close(self, wait: bool = True) -> None:
        self._closed = True
        if self._batcher is not None:
            self._batcher.close(wait=wait)
        self._executor.shutdown(wait=wait)
        for s in self._sessions:
            s.close()
        if self._batch_session is not None:
            self._batch_session.close()

    def __enter__(self) -> "SessionPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return f"SessionPool(size={self.size}, on {self.device})"
