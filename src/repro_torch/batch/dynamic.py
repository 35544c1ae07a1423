"""Dynamic batching: collect queued queries into batches as they arrive.

A copy of the reference's ``batch/dynamic.py`` (plain threading code). A
serving front door receives queries one at a time, but the batch engine
wants them K at a time. :class:`DynamicBatcher` bridges the two:
``submit()`` enqueues a query and returns a Future; a collector thread
drains the queue into batches — waiting up to ``max_wait_s`` after the
first query for stragglers, capping at ``max_batch``, and splitting on
parameter-signature boundaries so every batch it hands downstream is
batch-eligible (one shared key set). Queries keep their submission order
within and across batches, and a query count that is not a multiple of
``max_batch`` simply yields a final partial batch.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


@dataclass
class BatchServeStats:
    """Occupancy accounting for one batcher.

    ``sizes`` is a bounded window of the most recent batch sizes (long-lived
    serving processes must not accumulate one entry per batch forever);
    ``batches``/``queries`` are exact lifetime counters.
    """

    max_batch: int = 0
    batches: int = 0
    queries: int = 0
    sizes: "deque[int]" = field(default_factory=lambda: deque(maxlen=1024))

    @property
    def occupancy(self) -> float:
        """Mean fill ratio of the batches actually launched (1.0 = every
        batch was full)."""
        if not self.batches or not self.max_batch:
            return 0.0
        return self.queries / (self.batches * self.max_batch)


class DynamicBatcher:
    """Groups submitted queries into batches for a run_many-style callable.

    ``run_many`` receives a list of parameter dicts sharing one key set and
    must return one result per dict, in order. Exceptions from a batch are
    propagated to every Future in that batch.
    """

    def __init__(
        self,
        run_many: Callable[[List[Dict[str, Any]]], Sequence[Any]],
        max_batch: int = 16,
        max_wait_s: float = 0.002,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._run_many = run_many
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.stats = BatchServeStats(max_batch=max_batch)
        self._pending: "deque[Tuple[Dict[str, Any], Future]]" = deque()
        self._cond = threading.Condition()
        self._in_flight = 0  # queries handed to run_many, not yet resolved
        self._closed = False
        self._worker = threading.Thread(
            target=self._loop, name="repro-torch-batch-collector", daemon=True
        )
        self._worker.start()

    def submit(self, params: Dict[str, Any]) -> "Future[Any]":
        from ..core.session import ServiceClosed

        fut: "Future[Any]" = Future()
        with self._cond:
            if self._closed:
                raise ServiceClosed("DynamicBatcher is closed")
            self._pending.append((dict(params), fut))
            self._cond.notify()
        return fut

    @property
    def queue_depth(self) -> int:
        """Queries queued (not yet collected) + handed out but unresolved."""
        with self._cond:
            return len(self._pending) + self._in_flight

    # -- collector ----------------------------------------------------------
    def _take_batch(self) -> Optional[List[Tuple[Dict[str, Any], Future]]]:
        with self._cond:
            while not self._pending:
                if self._closed:
                    return None
                self._cond.wait()
            # wait a short window for the batch to fill up
            deadline = time.monotonic() + self.max_wait_s
            while len(self._pending) < self.max_batch and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            # one batch = one parameter signature (batch-eligibility)
            sig = frozenset(self._pending[0][0])
            items = []
            while (
                self._pending
                and len(items) < self.max_batch
                and frozenset(self._pending[0][0]) == sig
            ):
                items.append(self._pending.popleft())
            self._in_flight += len(items)
            return items

    def _loop(self) -> None:
        while True:
            items = self._take_batch()
            if items is None:
                return
            params = [p for p, _ in items]
            try:
                results = self._run_many(params)
            except BaseException as exc:  # surface to every waiter
                for _, fut in items:
                    fut.set_exception(exc)
                self._settle(len(items))
                continue
            self.stats.batches += 1
            self.stats.queries += len(items)
            self.stats.sizes.append(len(items))
            for (_, fut), res in zip(items, results):
                fut.set_result(res)
            self._settle(len(items))

    def _settle(self, n: int) -> None:
        with self._cond:
            self._in_flight -= n
            self._cond.notify_all()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until no query is queued or in flight; True on success.

        The streaming update path calls this (with no new submissions
        racing in — its write gate has already closed the front door) so a
        graph rebind never interleaves with a half-collected batch.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._pending or self._in_flight:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
            return True

    def close(self, wait: bool = True) -> None:
        """Stop accepting queries; drain what is already queued."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if wait:
            self._worker.join(timeout=300)
