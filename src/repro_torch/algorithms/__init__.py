"""The paper's evaluation algorithms, written in the Graphitron DSL.

Each algorithm is a ``.gt``-style source string (paper Fig. 1/2 syntax)
plus a convenience runner; BFS and PageRank also ship as embedded
:class:`~repro_torch.frontend.GraphProgram` twins (:mod:`.embedded`) that
compile to the same cache entry.
"""
from . import sources  # noqa: F401
from .sources import BFS_ECP, BFS_HYBRID, PAGERANK, SSSP, PPR, CGAW, WCC, KCORE  # noqa: F401
from .embedded import (  # noqa: F401
    BFS_ECP_EMBEDDED,
    PAGERANK_EMBEDDED,
    build_bfs_ecp,
    build_pagerank,
)
from .runners import (  # noqa: F401
    run_bfs,
    run_bfs_hybrid,
    run_pagerank,
    run_sssp,
    run_ppr,
    run_cgaw,
    run_wcc,
    run_kcore,
)

__all__ = [
    "BFS_ECP", "BFS_HYBRID", "PAGERANK", "SSSP", "PPR", "CGAW", "WCC", "KCORE",
    "BFS_ECP_EMBEDDED", "PAGERANK_EMBEDDED", "build_bfs_ecp", "build_pagerank",
    "run_bfs", "run_bfs_hybrid", "run_pagerank", "run_sssp", "run_ppr",
    "run_cgaw", "run_wcc", "run_kcore",
]
