"""Atomic, async, integrity-checked checkpoints of nested dicts of tensors."""
from .manager import CheckpointManager  # noqa: F401

__all__ = ["CheckpointManager"]
