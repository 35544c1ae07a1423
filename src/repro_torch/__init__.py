"""Graphitron on PyTorch and CUDA: the port of the ``repro`` package.

    import repro_torch
    from repro_torch import generators, sources

    g = generators.rmat(19, 32, seed=0)
    result = repro_torch.compile(sources.BFS_ECP).bind(g).run(root=0)

``bind`` places the program on ``"cuda"`` unless ``device="cpu"`` is
given. On the GPU every reduction a program scatters commits through the
hand-written CUDA kernels in :mod:`repro_torch.kernels`; on the CPU their
plain PyTorch versions run.
"""
from .core import (  # noqa: F401
    CompileOptions, EngineResult, Program, ProgramError, Session, SessionError, Target,
    compile,
)
from .graph import GraphData, generators, graph_from_arrays  # noqa: F401
from .algorithms import sources  # noqa: F401

__all__ = [
    "compile", "CompileOptions", "Target", "GraphData", "generators", "sources",
    "graph_from_arrays", "Program", "ProgramError", "Session", "SessionError",
    "EngineResult",
]
