"""The paper's evaluation programs as Graphitron ``.gt`` sources."""
from . import sources  # noqa: F401
from .sources import BFS_ECP, BFS_HYBRID, PAGERANK, SSSP, PPR, CGAW, WCC, KCORE  # noqa: F401
