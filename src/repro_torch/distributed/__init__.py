"""Distributed training helpers: the straggler monitor (LM sharding and the
compressed gradient reduction are not ported yet)."""
from .compression import StragglerMonitor  # noqa: F401

__all__ = ["StragglerMonitor"]
