"""Hand-written CUDA kernels and their plain PyTorch versions."""
from . import edge_stream, flash_attention, moe_dispatch, ref, shuffle_reduce  # noqa: F401
