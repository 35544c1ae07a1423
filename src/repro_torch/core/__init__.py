"""Compiler and single-device runtime: front end, passes, back end, engine."""
from .engine import Engine, EngineResult, EngineStats  # noqa: F401
from .options import CompileOptions  # noqa: F401
from .program import Program, ProgramError, compile  # noqa: F401,A004
from .session import (  # noqa: F401
    BatchSession, ServiceClosed, Session, SessionError, SessionPool, batch_eligible,
)
from .target import Target  # noqa: F401
