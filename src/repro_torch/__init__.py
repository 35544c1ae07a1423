"""Graphitron on PyTorch and CUDA: the port of the ``repro`` package.

    import repro_torch
    from repro_torch import generators, sources

    g = generators.rmat(19, 32, seed=0)
    result = repro_torch.compile(sources.BFS_ECP).bind(g).run(root=0)
    results = repro_torch.compile(sources.BFS_ECP).bind_batch(g).run_many(
        [{"root": r} for r in range(64)])   # one launch set for 64 queries

    acc = repro_torch.compile(sources.BFS_ECP).lower(graph=g)  # once a bucket
    acc2 = repro_torch.load_accelerator(acc.save("bfs-r19"))  # another process
    acc2.bind(g).run(root=0)         # any graph of the bucket, kernels warm

    acc = repro_torch.compile(sources.BFS_ECP).lower(graph=g, bucket=True)  # with slack
    ss = repro_torch.StreamingSession(
        acc.program, g.pad_to(acc.shape.n_vertices, acc.shape.n_edges), accelerator=acc)
    ss.run(root=0)
    ss.update(repro_torch.GraphDelta(added_edges=[(0, 7)]))  # in place, version 1
    ss.run(root=0)                   # a host repair of the cached answer

    repro_torch.telemetry.enable()   # spans: compile, lower, bind, run, launch:<k>,
                                     # update, repair, schedule, queue_wait,
                                     # batch_form, execute, autotune

    service = repro_torch.serve("artifacts")       # GraphService on "cuda"
    fut = service.submit("bfs", g, root=3)         # batched, multi-tenant
    service.run(BFS_ECP_EMBEDDED, g, root=4)       # an embedded twin: one entry
    repro_torch.analyze(src).render()               # GT001-GT502 diagnostics
    repro_torch.AutoTuner().tune(prog, g, params={"root": 0})   # Target search

``bind`` places the program on ``"cuda"`` unless ``device="cpu"`` is
given. On the GPU every reduction a program scatters commits through the
hand-written CUDA kernels in :mod:`repro_torch.kernels`; on the CPU their
plain PyTorch versions run. ``lower``, ``load_accelerator``, ``serve``,
``AutoTuner`` and the runners take the same ``device=`` as ``bind``;
:func:`run` takes its service's from
``repro_torch.serving.reset_default_service(device=...)``.
"""
from .core import (  # noqa: F401
    Accelerator, AcceleratorError, BatchSession, CompileOptions, EngineResult, GraphShape,
    Program, ProgramError, ServiceClosed, Session, SessionError, SessionPool, Target, compile,
    compile_program, load_accelerator, load_or_lower, program_cache_info,
    set_program_cache_limit,
)
from .analysis import AnalysisResult, Diagnostic, analyze  # noqa: F401
from .frontend import FrontendError, GraphProgram  # noqa: F401
from . import telemetry  # noqa: F401
from .graph import GraphData, generators, graph_from_arrays  # noqa: F401
from .graph.storage import GraphDelta, GraphUpdateError  # noqa: F401
from .streaming import StreamingSession  # noqa: F401
from .algorithms import sources  # noqa: F401
from . import autotune  # noqa: F401
from .autotune import AutoTuner, TunedConfig, TuningCache  # noqa: F401
from .serving import (  # noqa: F401
    ArtifactRegistry, DeadlineExceeded, GraphService, Overloaded, ProgramRejected,
    ServingError, run, serve,
)

__all__ = [
    "compile", "compile_program", "CompileOptions", "Target", "GraphData", "generators",
    "sources", "graph_from_arrays", "Program", "ProgramError", "GraphProgram",
    "FrontendError", "Session", "SessionError", "EngineResult", "BatchSession",
    "SessionPool", "ServiceClosed", "GraphShape", "Accelerator", "AcceleratorError",
    "load_accelerator", "load_or_lower", "program_cache_info", "set_program_cache_limit",
    "telemetry", "GraphDelta", "GraphUpdateError", "StreamingSession", "analyze",
    "AnalysisResult", "Diagnostic", "autotune", "AutoTuner", "TunedConfig", "TuningCache",
    "ArtifactRegistry", "GraphService", "ServingError", "Overloaded", "DeadlineExceeded",
    "ProgramRejected", "serve", "run",
]
