"""Hand-written CUDA kernels and their plain PyTorch versions."""
from . import edge_stream, ref, shuffle_reduce  # noqa: F401
