"""Sessions: a bound (program, graph, device) triple you run many times.

    session = program.bind(graph)          # device="cuda" by default
    result = session.run(root=3)

``run(**params)`` validates the keyword parameters against the program's
declared host scalars, resets device/host state (keeping lowered kernels
and the graph bindings on the device), applies the parameters, and
executes.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from .engine import Engine, EngineResult
from .program import Program
from .target import Target


class SessionError(Exception):
    pass


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


class Session:
    """One program bound to one graph on one device; run it many times."""

    def __init__(self, program: Program, graph, *, target: Optional[Target] = None,
                 device: Optional[str] = None, argv: Optional[list] = None):
        self.program = program
        self.graph = graph
        self.device = resolve_device(device)
        self.target = target if target is not None else Target()
        argv = list(argv) if argv is not None else ["prog", "<graph>"]
        self.engine = Engine(program.module, graph, self.target, self.device, argv=argv)
        self.runs = 0
        self._lock = threading.Lock()

    def run(self, **params) -> EngineResult:
        """Execute the bound program with explicit run-time parameters."""
        coerced = self.program.validate_params(params)
        with self._lock:  # a Session is a stateful device context
            self.engine.reset()
            self.engine.host_env.update(coerced)
            result = self.engine.run()
            self.runs += 1
        return result

    def __repr__(self) -> str:
        return (f"Session(on {self.device}, |V|={getattr(self.graph, 'n_vertices', '?')}, "
                f"runs={self.runs})")
