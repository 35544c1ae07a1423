"""The LM stack: GQA attention and MoE through the hand-written kernels."""
from . import attention, convert, layers, moe  # noqa: F401
from .convert import params_from_numpy  # noqa: F401
from .model import Model  # noqa: F401

__all__ = ["Model", "attention", "convert", "layers", "moe", "params_from_numpy"]
