"""Graphitron on PyTorch and CUDA: the port of the ``repro`` package.

    import repro_torch
    from repro_torch import generators, sources

    g = generators.rmat(19, 32, seed=0)
    result = repro_torch.compile(sources.BFS_ECP).bind(g).run(root=0)
    results = repro_torch.compile(sources.BFS_ECP).bind_batch(g).run_many(
        [{"root": r} for r in range(64)])   # one launch set for 64 queries

``bind`` places the program on ``"cuda"`` unless ``device="cpu"`` is
given. On the GPU every reduction a program scatters commits through the
hand-written CUDA kernels in :mod:`repro_torch.kernels`; on the CPU their
plain PyTorch versions run.
"""
from .core import (  # noqa: F401
    BatchSession, CompileOptions, EngineResult, Program, ProgramError, ServiceClosed, Session,
    SessionError, SessionPool, Target, compile,
)
from .graph import GraphData, generators, graph_from_arrays  # noqa: F401
from .algorithms import sources  # noqa: F401

__all__ = [
    "compile", "CompileOptions", "Target", "GraphData", "generators", "sources",
    "graph_from_arrays", "Program", "ProgramError", "Session", "SessionError",
    "EngineResult", "BatchSession", "SessionPool", "ServiceClosed",
]
