"""The LM stack: attention and MoE through the hand-written kernels; the
Mamba2 and xLSTM recurrences in plain PyTorch."""
from . import attention, convert, layers, moe, ssm, xlstm  # noqa: F401
from .convert import params_from_numpy  # noqa: F401
from .model import Model  # noqa: F401

__all__ = ["Model", "attention", "convert", "layers", "moe", "params_from_numpy", "ssm", "xlstm"]
