"""Convenience runners: thin wrappers over the Program/Session API.

Each runner compiles its algorithm once (``repro_torch.compile`` is keyed by a
content hash of the canonical MIR + options, so repeated calls share one
artifact), binds a session to the caller's graph, and runs it with
explicit parameters. Each returns the algorithm's primary result array
(mapped back to original vertex/edge ids) plus the EngineResult for
stats inspection.

Every runner takes an optional ``source`` override accepting **either
front-end** — a ``.gt`` text string or an embedded
:class:`repro_torch.frontend.GraphProgram` (e.g. the twins in
:mod:`repro_torch.algorithms.embedded`) — as long as it declares the
properties/parameters the runner extracts.

Every runner takes ``device=`` as ``bind`` does: ``None`` means
``"cuda"``, which raises without a GPU unless the caller asks for
``device="cpu"``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, TYPE_CHECKING, Union

import numpy as np

from ..core import CompileOptions
from ..core.program import compile_program
from ..graph.storage import GraphData
from . import sources

if TYPE_CHECKING:  # pragma: no cover
    from ..frontend import GraphProgram

Source = Union[str, "GraphProgram"]

# immutable: every bind() gets a fresh list (a caller mutating its
# session's argv must not be able to poison subsequent runners)
_ARGV = ("prog", "<graph>")


def _run(
    src: Source,
    graph: GraphData,
    options: Optional[CompileOptions],
    params: Dict,
    device: Optional[str] = None,
):
    session = compile_program(src, options).bind(
        graph, device=device, argv=list(_ARGV)
    )
    return session.run(**params)


def run_bfs(
    graph: GraphData,
    root: int = 0,
    options: Optional[CompileOptions] = None,
    device: Optional[str] = None,
    source: Optional[Source] = None,
) -> Tuple[np.ndarray, object]:
    res = _run(source if source is not None else sources.BFS_ECP,
               graph, options, {"root": root}, device)
    return res.properties["old_level"], res


def run_bfs_hybrid(
    graph: GraphData,
    root: int = 0,
    options: Optional[CompileOptions] = None,
    device: Optional[str] = None,
    source: Optional[Source] = None,
) -> Tuple[np.ndarray, object]:
    res = _run(source if source is not None else sources.BFS_HYBRID,
               graph, options, {"root": root}, device)
    return res.properties["old_level"], res


def run_pagerank(
    graph: GraphData,
    iters: int = 20,
    options: Optional[CompileOptions] = None,
    device: Optional[str] = None,
    source: Optional[Source] = None,
) -> Tuple[np.ndarray, object]:
    res = _run(source if source is not None else sources.PAGERANK,
               graph, options, {"iters": iters}, device)
    return res.properties["rank"], res


def run_sssp(
    graph: GraphData,
    root: int = 0,
    options: Optional[CompileOptions] = None,
    device: Optional[str] = None,
    source: Optional[Source] = None,
) -> Tuple[np.ndarray, object]:
    res = _run(source if source is not None else sources.SSSP,
               graph, options, {"root": root}, device)
    return res.properties["SP"], res


def run_ppr(
    graph: GraphData,
    source: int = 0,
    options: Optional[CompileOptions] = None,
    max_iters: int = 100,
    device: Optional[str] = None,
    program: Optional[Source] = None,
) -> Tuple[np.ndarray, object]:
    # NB: `source` here is the personalization vertex (paper Algorithm 1),
    # so the front-end override parameter is named `program`
    res = _run(
        program if program is not None else sources.PPR,
        graph, options, {"source": source, "max_iters": max_iters}, device,
    )
    return res.properties["PR_old"], res


def run_cgaw(
    graph: GraphData,
    options: Optional[CompileOptions] = None,
    device: Optional[str] = None,
    source: Optional[Source] = None,
) -> Tuple[np.ndarray, object]:
    res = _run(source if source is not None else sources.CGAW,
               graph, options, {}, device)
    return res.properties["weight"], res


def run_wcc(
    graph: GraphData,
    options: Optional[CompileOptions] = None,
    device: Optional[str] = None,
    source: Optional[Source] = None,
) -> Tuple[np.ndarray, object]:
    res = _run(source if source is not None else sources.WCC,
               graph, options, {}, device)
    return res.properties["comp"], res


def run_kcore(
    graph: GraphData,
    k: int = 2,
    options: Optional[CompileOptions] = None,
    device: Optional[str] = None,
    source: Optional[Source] = None,
) -> Tuple[np.ndarray, object]:
    res = _run(source if source is not None else sources.KCORE,
               graph, options, {"k": k}, device)
    return res.properties["alive"], res


def make_warm_runner(
    src: Source,
    graph: GraphData,
    options: Optional[CompileOptions] = None,
    overrides: Optional[dict] = None,
    device: Optional[str] = None,
    aot: bool = False,
):
    """Deprecated: use ``repro_torch.run(src, graph, **params)`` /
    ``repro_torch.serve()``.

    The serving tier supersedes this wrapper — ``repro_torch.run`` routes
    through the same resident-session / warm-artifact / cold-compile
    selection with registry-wide reuse, and ``repro_torch.serve()`` adds
    batching, tenants, and deadlines. Kept as a shim for existing
    callers; emits a :class:`DeprecationWarning`.
    """
    import warnings

    warnings.warn(
        "make_warm_runner is deprecated: use repro_torch.run(src, graph, **params) "
        "for one-shot warm execution, or repro_torch.serve() for a long-lived "
        "GraphService (resident sessions, artifact warm starts, batching)",
        DeprecationWarning,
        stacklevel=2,
    )
    return _make_warm_runner(src, graph, options, overrides, device, aot)


def _make_warm_runner(
    src: Source,
    graph: GraphData,
    options: Optional[CompileOptions] = None,
    overrides: Optional[dict] = None,
    device: Optional[str] = None,
    aot: bool = False,
):
    """Bind a session once (compiling all kernels on the first call) and
    return a zero-arg callable that re-runs it — the "post-synthesis
    accelerator execution" timing mode. ``src`` is text or embedded.

    ``aot=True`` routes through the Accelerator path instead:
    ``program.lower(target, shape).bind(graph)`` — kernels are AOT-compiled
    against the graph's shape bucket before the first run, which is the
    honest analogue of timing a synthesized bitstream (and lets callers
    reuse the accelerator via ``runner.accelerator`` for same-shape
    graphs)."""
    program = compile_program(src, options)
    accelerator = None
    if aot:
        accelerator = program.lower(graph=graph, device=device)
        session = accelerator.bind(graph, argv=list(_ARGV))
    else:
        session = program.bind(graph, device=device, argv=list(_ARGV))
    params = dict(overrides or {})

    def run():
        return session.run(**params)

    run()  # warm: compile (or first-touch) every kernel launch path
    run.accelerator = accelerator
    run.session = session
    return run
