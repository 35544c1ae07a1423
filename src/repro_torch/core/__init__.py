"""Compiler and runtime: front end, passes, back end, the one-device engine
and the multi-device one (``Target(kind="distributed")``), and the
accelerator artifacts."""
from .accelerator import (  # noqa: F401
    Accelerator, AcceleratorError, GraphShape, load_accelerator, load_or_lower,
)
from .dist_engine import DistEngine, DistGraph, partition_graph  # noqa: F401
from .engine import Engine, EngineResult, EngineStats  # noqa: F401
from .options import CompileOptions  # noqa: F401
from .program import (  # noqa: F401
    Program, ProgramError, compile, compile_program, program_cache_info,  # noqa: A004
    set_program_cache_limit,
)
from .session import (  # noqa: F401
    BatchSession, ServiceClosed, Session, SessionError, SessionPool, batch_eligible,
)
from .target import Target  # noqa: F401
