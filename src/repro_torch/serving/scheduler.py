"""Async request scheduler: admission control, fairness, deadlines, batching.

The serving front door accepts queries one at a time; the execution tier
wants them grouped (one :class:`~repro_torch.core.session.BatchSession` launch
answers K queries). :class:`RequestScheduler` fuses the
:class:`~repro_torch.batch.dynamic.DynamicBatcher` collection idea with the
policies a multi-tenant service needs:

* **admission control** — per-tenant bounded queues; a full queue sheds
  load with a typed :class:`Overloaded` (callers retry elsewhere/later
  instead of piling onto an unbounded backlog). In-flight work is
  bounded too (``workers * max_batch``), so backpressure keeps excess
  requests in the tenant queues where admission policies apply.
* **weighted fairness** — batch formation picks the tenant minimizing
  ``served / weight`` among non-empty queues: a weight-3 tenant gets ~3x
  the service of a weight-1 tenant under contention, and an idle
  tenant's unused share flows to the others.
* **deadlines** — ``deadline_s`` is propagated to batch formation: the
  fill-wait for stragglers never sleeps past the earliest deadline in
  the forming batch, and a request that expires while queued is failed
  with :class:`DeadlineExceeded` *without* occupying an execution slot.
  A request that completes past its deadline still returns its result
  (the caller may use it) but is counted as a deadline miss.
* **batching** — within one tenant pick, requests sharing a group key
  (same program x graph x parameter-key signature) coalesce up to
  ``max_batch``; the executor answers them with one batched run.

The scheduler is execution-agnostic: it calls
``execute(job, param_sets) -> results`` (the service maps ``job`` to a
registry entry); tests drive it with plain callables.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from .. import telemetry as tel
from ..core.session import ServiceClosed
from .metrics import ServeMetrics

__all__ = [
    "DeadlineExceeded",
    "Overloaded",
    "Request",
    "RequestScheduler",
    "ServingError",
]


class ServingError(Exception):
    """Base class for serving-tier request failures."""


class Overloaded(ServingError):
    """Admission refused: the tenant's queue is full (load shedding)."""


class DeadlineExceeded(ServingError):
    """The request's deadline expired before execution began."""


class Request:
    """One admitted query waiting for batch formation."""

    __slots__ = (
        "job", "params", "group_key", "tenant", "label",
        "deadline", "future", "t_submit", "t_submit_pc", "t_join_pc", "ctx",
    )

    def __init__(self, job: Any, params: Dict[str, Any], group_key: Any,
                 tenant: str, label: str,
                 deadline: Optional[float]) -> None:
        self.job = job
        self.params = params
        self.group_key = group_key
        self.tenant = tenant
        self.label = label
        self.deadline = deadline  # absolute time.monotonic(), or None
        self.future: "Future[Any]" = Future()
        self.t_submit = time.monotonic()
        self.t_submit_pc = time.perf_counter()
        self.t_join_pc = 0.0  # set when the request joins a forming batch
        # span context of the submitting thread: batch formation and
        # execution happen on other threads, so their spans parent here
        self.ctx = tel.current()


class RequestScheduler:
    """Admit, order, batch, and dispatch requests to an execute callable."""

    def __init__(
        self,
        execute: Callable[[Any, List[Dict[str, Any]]], List[Any]],
        *,
        workers: int = 2,
        max_batch: int = 8,
        max_wait_s: float = 0.002,
        max_queue: int = 128,
        tenant_weights: Optional[Dict[str, float]] = None,
        metrics: Optional[ServeMetrics] = None,
    ) -> None:
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self._execute = execute
        self.workers = workers
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.max_queue = max_queue  # per tenant
        self.metrics = metrics if metrics is not None else ServeMetrics(max_batch)
        self.metrics.max_batch = max_batch
        self._weights = {
            t: float(w) for t, w in (tenant_weights or {}).items()
        }
        self._served: Dict[str, int] = {}  # queries dispatched per tenant
        self._queues: Dict[str, Deque[Request]] = {}
        self._cond = threading.Condition()
        self._in_flight = 0  # queries dispatched, not yet resolved
        self._closed = False
        self._executor = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="repro-torch-serve"
        )
        self._collector = threading.Thread(
            target=self._loop, name="repro-torch-serve-collector", daemon=True
        )
        self._collector.start()

    # -- admission -----------------------------------------------------------
    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, 1.0)

    def submit(self, job: Any, params: Dict[str, Any], *, group_key: Any,
               tenant: str = "default", label: str = "?",
               deadline_s: Optional[float] = None) -> "Future[Any]":
        deadline = (
            time.monotonic() + deadline_s if deadline_s is not None else None
        )
        req = Request(job, dict(params), group_key, tenant, label, deadline)
        with self._cond:
            if self._closed:
                raise ServiceClosed("RequestScheduler is closed")
            q = self._queues.setdefault(tenant, deque())
            if len(q) >= self.max_queue:
                self.metrics.rejected(tenant, label, "overloaded")
                raise Overloaded(
                    f"tenant {tenant!r} queue is full "
                    f"({self.max_queue} requests waiting)"
                )
            q.append(req)
            self.metrics.submitted(tenant, label)
            self._cond.notify_all()
        return req.future

    @property
    def queue_depth(self) -> int:
        """Requests queued (all tenants) + dispatched but unresolved."""
        with self._cond:
            return sum(len(q) for q in self._queues.values()) + self._in_flight

    # -- batch formation -----------------------------------------------------
    def _drop_expired_locked(self, now: float) -> None:
        """Fail queued requests whose deadline already passed (head-of-queue
        scan per tenant: queues are FIFO per tenant, but deadlines are not
        necessarily ordered, so scan the whole queue)."""
        for tenant, q in self._queues.items():
            if not q:
                continue
            keep: Deque[Request] = deque()
            for req in q:
                if req.deadline is not None and now >= req.deadline:
                    self.metrics.rejected(req.tenant, req.label, "deadline")
                    req.future.set_exception(DeadlineExceeded(
                        f"deadline expired after "
                        f"{now - req.t_submit:.3f}s in queue"
                    ))
                else:
                    keep.append(req)
            self._queues[tenant] = keep

    def _pick_tenant_locked(self) -> Optional[str]:
        """Weighted fairness: argmin served/weight over non-empty queues."""
        best, best_score = None, None
        for tenant, q in self._queues.items():
            if not q:
                continue
            score = self._served.get(tenant, 0) / self.weight(tenant)
            if best_score is None or score < best_score:
                best, best_score = tenant, score
        return best

    def _earliest_deadline_locked(self) -> Optional[float]:
        earliest = None
        for q in self._queues.values():
            for req in q:
                if req.deadline is not None:
                    earliest = (
                        req.deadline if earliest is None
                        else min(earliest, req.deadline)
                    )
        return earliest

    def _take_batch(self) -> Optional[List[Request]]:
        """Block until a batch can be formed; None when closed and drained."""
        with self._cond:
            while True:
                self._drop_expired_locked(time.monotonic())
                have = any(self._queues.values())
                room = self._in_flight < self.workers * self.max_batch
                if have and room:
                    break
                if self._closed and not have:
                    return None
                # sleep until new work / freed slot — but never past the
                # earliest queued deadline (those must be failed on time)
                timeout = None
                earliest = self._earliest_deadline_locked()
                if earliest is not None:
                    timeout = max(0.0, earliest - time.monotonic()) + 1e-4
                self._cond.wait(timeout=timeout)
            tenant = self._pick_tenant_locked()
            q = self._queues[tenant]
            head = q.popleft()
            head.t_join_pc = time.perf_counter()
            batch = [head]
            if self.max_batch > 1:
                # wait briefly for same-group stragglers — capped by the
                # forming batch's earliest deadline (SLO beats occupancy)
                limit = time.monotonic() + self.max_wait_s
                if head.deadline is not None:
                    limit = min(limit, head.deadline)
                while len(batch) < self.max_batch:
                    while q and q[0].group_key == head.group_key:
                        straggler = q.popleft()
                        straggler.t_join_pc = time.perf_counter()
                        batch.append(straggler)
                        if len(batch) >= self.max_batch:
                            break
                    if len(batch) >= self.max_batch or self._closed:
                        break
                    remaining = limit - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(timeout=remaining)
            self._in_flight += len(batch)
            self._served[tenant] = self._served.get(tenant, 0) + len(batch)
        tr = tel.get()
        if tr.enabled:
            # fill-wait: head pop -> batch sealed (the head pays it all)
            tr.record_span(
                "batch_form", head.t_join_pc, time.perf_counter(),
                parent=head.ctx, tenant=tenant, batch=len(batch),
            )
            for req in batch:
                tr.record_span(
                    "queue_wait", req.t_submit_pc, req.t_join_pc,
                    parent=req.ctx, tenant=req.tenant, label=req.label,
                )
        return batch

    # -- dispatch ------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                self._executor.submit(self._run_batch, batch)
            except RuntimeError:
                # executor already shut down (close raced the collector):
                # fail the batch instead of dropping it silently
                exc = ServiceClosed("RequestScheduler is closed")
                for req in batch:
                    req.future.set_exception(exc)
                self._settle(len(batch))

    def _run_batch(self, batch: List[Request]) -> None:
        self.metrics.batch(len(batch))
        head = batch[0]
        tr = tel.get()
        # live span on the worker thread, parented to the head request's
        # submit-side context: engine spans opened inside _execute nest
        # under it, keeping one connected tree per request
        sp = (
            tr.span("execute", parent=head.ctx, tenant=head.tenant,
                    label=head.label, batch=len(batch))
            if tr.enabled else tel.NULL_SPAN
        )
        try:
            with sp:
                results = self._execute(
                    batch[0].job, [r.params for r in batch]
                )
        except BaseException as exc:
            for req in batch:
                self.metrics.error(req.tenant, req.label)
                req.future.set_exception(exc)
            self._settle(len(batch))
            return
        if tr.enabled and len(batch) > 1:
            # stragglers share the head's execution interval: mirror it
            # into each request's own tree so every tree carries the
            # full queue-wait vs execution split
            for req in batch[1:]:
                tr.record_span(
                    "execute", sp.t_start, sp.t_end, parent=req.ctx,
                    tenant=req.tenant, label=req.label,
                    batch=len(batch), shared=True,
                )
        now = time.monotonic()
        for req, res in zip(batch, results):
            missed = req.deadline is not None and now > req.deadline
            self.metrics.completed(
                req.tenant, req.label, now - req.t_submit,
                deadline_missed=missed,
            )
            req.future.set_result(res)
        self._settle(len(batch))

    def _settle(self, n: int) -> None:
        with self._cond:
            self._in_flight -= n
            self._cond.notify_all()

    # -- lifecycle -----------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until nothing is queued or in flight; True on success."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while any(self._queues.values()) or self._in_flight:
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
            return True

    def close(self, wait: bool = True) -> None:
        """Stop admissions; drain what is already queued."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        if wait:
            self._collector.join(timeout=300)
        self._executor.shutdown(wait=wait)
