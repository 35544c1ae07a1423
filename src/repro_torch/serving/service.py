"""`repro_torch.serve()`: the one-call serving surface over compiled graph programs.

    import repro_torch

    service = repro_torch.serve()                 # or repro_torch.serve(dir)
    fut = service.submit("bfs", graph, root=3)    # async, batched
    res = service.run("pagerank", graph, iters=20)  # sync one-shot

``submit`` accepts a program by **name** (the built-in algorithm table),
as ``.gt`` source text, as an embedded
:class:`~repro_torch.frontend.GraphProgram`, or as an already-compiled
:class:`~repro_torch.core.program.Program` — and transparently picks the
cheapest execution path: an already-resident session, a warm on-disk
accelerator artifact, or a cold compile (which is saved back for the
next process). Multi-tenant policies (bounded queues with typed
:class:`~repro_torch.serving.scheduler.Overloaded` shedding, weighted
fairness, per-request deadlines) ride on every call via ``tenant=`` /
``deadline_s=``; ``service.stats()`` exports the metrics snapshot.
Unless a Target is pinned, every submission resolves its Target through
the :mod:`repro_torch.autotune` TuningCache (lookup only) — offline-tuned
configs apply transparently and count as ``tuned_hits``.

``repro_torch.run(src_or_program, graph, **params)`` is the module-level
one-shot convenience: it routes through a process-wide default
:class:`GraphService`, so repeated calls reuse resident sessions and
warm artifacts exactly like a long-lived service would.

The service runs on one device, given as ``serve(..., device=)``:
``None`` means ``"cuda"``, which raises at the first bind on a machine
without a GPU; nothing falls back to the CPU. ``run()``'s keyword
arguments are the program's parameters, so the default service takes its
device from :func:`reset_default_service` (``reset_default_service(
device="cpu")``), never from a query.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple, Union

from .. import telemetry as tel
from ..core.program import Program, compile_program
from ..core.session import ServiceClosed
from ..core.target import Target
from .metrics import ServeMetrics
from .registry import ArtifactRegistry, default_artifact_dir
from .scheduler import RequestScheduler, ServingError

__all__ = ["GraphService", "ProgramRejected", "serve", "run", "NAMED_ALGORITHMS"]


class ProgramRejected(ServingError):
    """Static analysis found error-level diagnostics at admission.

    Raised by :meth:`GraphService.submit` *before* the program reaches the
    scheduler or registry — a racy or otherwise broken program never
    occupies queue or artifact capacity. ``diagnostics`` carries the
    error-level :class:`~repro_torch.analysis.Diagnostic` objects.
    """

    def __init__(self, label: str, diagnostics) -> None:
        self.label = label
        self.diagnostics = tuple(diagnostics)
        detail = "; ".join(
            f"{d.code} {d.message.splitlines()[0]}" for d in self.diagnostics
        )
        super().__init__(
            f"program {label!r} rejected by static analysis "
            f"({len(self.diagnostics)} error(s)): {detail}"
        )


def _named_algorithms() -> Dict[str, str]:
    from ..algorithms import sources

    return {
        "bfs": sources.BFS_ECP,
        "bfs_hybrid": sources.BFS_HYBRID,
        "pagerank": sources.PAGERANK,
        "sssp": sources.SSSP,
        "ppr": sources.PPR,
        "cgaw": sources.CGAW,
        "wcc": sources.WCC,
        "kcore": sources.KCORE,
    }


class _Named(dict):
    """Lazy name -> .gt source table (avoids import work at module load)."""

    def _fill(self) -> None:
        if not self:
            self.update(_named_algorithms())

    def __missing__(self, key):
        self._fill()
        if key in self:
            return self[key]
        raise KeyError(key)

    def __contains__(self, key) -> bool:
        self._fill()
        return dict.__contains__(self, key)


NAMED_ALGORITHMS = _Named()


class GraphService:
    """A long-lived, multi-tenant serving instance.

    Parameters
    ----------
    registry_dir
        On-disk artifact store for warm cross-process starts. Defaults to
        ``$REPRO_TORCH_ARTIFACT_DIR`` / ``~/.cache/repro-torch-artifacts``; pass
        ``registry_dir=False`` for a memory-only registry.
    backend / target
        ``backend`` is the substrate kind: ``"local"`` (one device) or
        ``"distributed"`` (``Target(kind="distributed")``: shuffle
        supersteps across every visible device of ``device``'s type). An
        explicit ``target`` pins one
        :class:`~repro_torch.core.target.Target` for every submission.
    device
        The device every binding of this service lives on, as for
        ``Program.bind``: ``None`` means ``"cuda"``.
    autotune
        When True (the default) and no explicit ``target`` is pinned,
        each submission's Target is resolved through the
        :class:`~repro_torch.autotune.TuningCache` colocated with the artifact
        store — a pure lookup keyed on (MIR fingerprint x shape bucket),
        never a search. Hits are counted per tenant/program as
        ``tuned_hits`` in :meth:`stats`.
    workers / max_batch / max_wait_s / max_queue / tenant_weights
        Scheduler shape: executor width, batch-formation cap and
        fill-wait, per-tenant admission bound, fairness weights
        (unlisted tenants weigh 1.0).
    max_resident / max_accelerators
        Registry bounds: live bindings (LRU, pin-safe eviction) and
        cached lowerings.
    """

    def __init__(
        self,
        registry_dir: Union[str, None, bool] = None,
        *,
        backend: str = "local",
        target: Optional[Target] = None,
        workers: int = 2,
        max_batch: int = 8,
        max_wait_s: float = 0.002,
        max_queue: int = 128,
        tenant_weights: Optional[Dict[str, float]] = None,
        max_resident: int = 8,
        max_accelerators: int = 32,
        autotune: bool = True,
        options=None,
        device: Optional[str] = None,
    ) -> None:
        from ..autotune import TuningCache, tuning_dir_for

        Target(kind=backend)  # an unknown backend fails here, not at a submission

        if registry_dir is None:
            store: Optional[str] = default_artifact_dir()
        elif registry_dir is False:
            store = None
        else:
            store = str(registry_dir)
        self.backend = backend
        self.device = device
        self.options = options
        self._target = target
        self.autotune = bool(autotune)
        # memory-only when the registry is (store=None): tuned configs
        # still apply within the process once something puts them there
        self.tuning = TuningCache(tuning_dir_for(store))
        self.metrics = ServeMetrics(max_batch=max_batch)
        self.registry = ArtifactRegistry(
            store, max_resident=max_resident,
            max_accelerators=max_accelerators, max_batch=max_batch,
            metrics=self.metrics, device=device,
        )
        self.scheduler = RequestScheduler(
            self._execute, workers=workers, max_batch=max_batch,
            max_wait_s=max_wait_s, max_queue=max_queue,
            tenant_weights=tenant_weights, metrics=self.metrics,
        )
        self.metrics.queue_depth_fn = lambda: self.scheduler.queue_depth
        self._closed = False

    # -- program resolution --------------------------------------------------
    def _resolve_program(self, program_or_name) -> Tuple[Program, str]:
        """(Program, metrics label) for a name / source / Program input."""
        if isinstance(program_or_name, Program):
            return program_or_name, program_or_name.fingerprint[:12]
        if isinstance(program_or_name, str) and program_or_name in NAMED_ALGORITHMS:
            program = compile_program(
                NAMED_ALGORITHMS[program_or_name], self.options
            )
            return program, program_or_name
        # .gt text or an embedded GraphProgram: the Program cache
        # (content-hash keyed) makes repeated resolution cheap
        program = compile_program(program_or_name, self.options)
        label = getattr(program_or_name, "name", None)
        return program, str(label) if label else program.fingerprint[:12]

    def _target_for(self, program: Program,
                    graph=None) -> Tuple[Target, bool]:
        """(Target, tuned) for one submission.

        An explicit pinned target always wins (the operator opted out of
        tuning); otherwise a TuningCache hit for (program MIR x graph
        shape bucket x backend) swaps in the tuned Target — lookup only,
        zero search trials.
        """
        if self._target is not None:
            return self._target, False
        resolved = Target(kind=self.backend)
        if self.autotune and graph is not None:
            from ..autotune import program_mir_fingerprint, shape_bucket

            cfg = self.tuning.get(
                program_mir_fingerprint(program), shape_bucket(graph=graph),
                kind=self.backend,
            )
            if cfg is not None:
                return cfg.target, True
        return resolved, False

    # -- execution (called by scheduler workers) -----------------------------
    def _execute(self, job, param_sets):
        program, graph, target = job
        entry = self.registry.acquire(program, graph, target)
        try:
            return entry.run_many(param_sets)
        finally:
            entry.release()

    # -- public API ----------------------------------------------------------
    def submit(self, program_or_name, graph, *, tenant: str = "default",
               deadline_s: Optional[float] = None, **params):
        """Async: admit one query, get a Future.

        Raises :class:`~repro_torch.serving.scheduler.Overloaded` when the
        tenant's queue is full, :class:`ProgramRejected` when static
        analysis finds error-level diagnostics (counted per-tenant as
        ``rejections_analysis`` in :meth:`stats`), and
        :class:`ServiceClosed` after :meth:`close`; parameter validation
        fails fast on the caller.
        """
        if self._closed:
            raise ServiceClosed("GraphService is closed")
        tr = tel.get()
        if not tr.enabled:
            return self._submit_impl(
                program_or_name, graph, tenant, deadline_s, params,
                tel.NULL_SPAN,
            )
        # root span of this request's trace: queue_wait / batch_form /
        # execute spans recorded on scheduler threads parent to it via
        # the Request's captured SpanContext
        with tr.span("schedule", tenant=tenant) as sp:
            return self._submit_impl(
                program_or_name, graph, tenant, deadline_s, params, sp
            )

    def _submit_impl(self, program_or_name, graph, tenant, deadline_s,
                     params, sp):
        program, label = self._resolve_program(program_or_name)
        sp.set(program=label, fingerprint=program.fingerprint[:16])
        analysis = program.diagnostics()
        if analysis.errors:
            self.metrics.rejected(tenant, label, "analysis")
            raise ProgramRejected(label, analysis.errors)
        coerced = program.validate_params(params)
        target, tuned = self._target_for(program, graph)
        if tuned:
            self.metrics.tuned_hit(tenant, label)
            sp.set(tuned=True)
        job = (program, graph, target)
        group_key = (
            program.fingerprint, id(graph), target, frozenset(coerced)
        )
        return self.scheduler.submit(
            job, coerced, group_key=group_key, tenant=tenant, label=label,
            deadline_s=deadline_s,
        )

    def run(self, program_or_name, graph, *, tenant: str = "default",
            deadline_s: Optional[float] = None, **params):
        """Sync one-shot: ``submit`` + wait."""
        return self.submit(
            program_or_name, graph, tenant=tenant, deadline_s=deadline_s,
            **params
        ).result()

    def update(self, program_or_name, graph, delta) -> int:
        """Apply a streaming delta to a served graph binding in place.

        Waits for in-flight queries on that binding (readers-writer gate,
        writer priority), applies the delta into the graph's padding
        slack, refreshes the binding, and bumps its version — subsequent
        results carry ``result.version`` of the updated graph. Returns
        the new version.
        """
        if self._closed:
            raise ServiceClosed("GraphService is closed")
        program, _ = self._resolve_program(program_or_name)
        # updates must land on the binding queries run against: resolve
        # through the same tuned-target lookup as the submit path
        target, _ = self._target_for(program, graph)
        entry = self.registry.acquire(program, graph, target)
        try:
            return entry.update(delta)
        finally:
            entry.release()

    def stats(self) -> Dict[str, Any]:
        """JSON-serializable metrics snapshot (see serving/metrics.py)."""
        snap = self.metrics.snapshot()
        snap["registry"] = {**snap["registry"], **self.registry.info()}
        snap["tuning"] = {
            "enabled": self.autotune, "store_dir": self.tuning.store_dir,
            **self.tuning.stats(),
        }
        tr = tel.get()
        if tr.enabled:
            snap["telemetry"] = tr.prometheus_text()
        return snap

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self, wait: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        self.scheduler.close(wait=wait)
        self.registry.close()

    def __enter__(self) -> "GraphService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        info = self.registry.info()
        return (
            f"GraphService(resident={info['resident']}, "
            f"store={info['store_dir']!r}, "
            f"closed={self._closed})"
        )


def serve(registry_dir: Union[str, None, bool] = None, **config) -> GraphService:
    """Start a :class:`GraphService` over an artifact registry.

    The redesigned deployment surface in one call: resident sessions,
    warm artifact starts, cold compiles, dynamic batching, multi-tenant
    admission/fairness/deadlines, and a metrics snapshot — see
    :class:`GraphService` for the knobs.
    """
    return GraphService(registry_dir, **config)


_default_service: Optional[GraphService] = None
_default_device: Optional[str] = None
_default_lock = threading.Lock()


def default_service() -> GraphService:
    """The process-wide service backing :func:`run` (created on demand,
    on the device the last :func:`reset_default_service` gave)."""
    global _default_service
    with _default_lock:
        if _default_service is None or _default_service.closed:
            _default_service = GraphService(device=_default_device)
        return _default_service


def reset_default_service(*, device: Optional[str] = None) -> None:
    """Close and forget the process-wide service (tests, env changes).

    ``device`` is where the next default service binds, e.g.
    ``reset_default_service(device="cpu")``; ``None`` means ``"cuda"``."""
    global _default_service, _default_device
    with _default_lock:
        svc, _default_service = _default_service, None
        _default_device = device
    if svc is not None and not svc.closed:
        svc.close()


def run(program_or_name, graph, **params):
    """One-shot convenience: serve one query through the default service.

    Routes through the same resident -> warm artifact -> cold compile
    selection as :meth:`GraphService.submit`, so the second call with the
    same (program, graph) pays zero compile time. Supersedes
    :func:`repro_torch.algorithms.runners.make_warm_runner` for ad-hoc use.
    """
    return default_service().run(program_or_name, graph, **params)
