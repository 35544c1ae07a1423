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
                                     # update, repair

``bind`` places the program on ``"cuda"`` unless ``device="cpu"`` is
given. On the GPU every reduction a program scatters commits through the
hand-written CUDA kernels in :mod:`repro_torch.kernels`; on the CPU their
plain PyTorch versions run. ``lower`` and ``load_accelerator`` take the same
``device=`` as ``bind``.
"""
from .core import (  # noqa: F401
    Accelerator, AcceleratorError, BatchSession, CompileOptions, EngineResult, GraphShape,
    Program, ProgramError, ServiceClosed, Session, SessionError, SessionPool, Target, compile,
    load_accelerator, load_or_lower, program_cache_info,
)
from . import telemetry  # noqa: F401
from .graph import GraphData, generators, graph_from_arrays  # noqa: F401
from .graph.storage import GraphDelta, GraphUpdateError  # noqa: F401
from .streaming import StreamingSession  # noqa: F401
from .algorithms import sources  # noqa: F401

__all__ = [
    "compile", "CompileOptions", "Target", "GraphData", "generators", "sources",
    "graph_from_arrays", "Program", "ProgramError", "Session", "SessionError",
    "EngineResult", "BatchSession", "SessionPool", "ServiceClosed", "GraphShape",
    "Accelerator", "AcceleratorError", "load_accelerator", "load_or_lower",
    "program_cache_info", "telemetry", "GraphDelta", "GraphUpdateError", "StreamingSession",
]
