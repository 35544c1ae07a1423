"""Evaluation algorithms authored through the embedded Python front-end.

These are the *exact* twins of their text sources in
:mod:`repro_torch.algorithms.sources` — same declarations in the same order,
same kernel bodies — so ``repro_torch.compile(BFS_ECP_EMBEDDED)`` and
``repro_torch.compile(sources.BFS_ECP)`` produce MIR-hash-identical modules
and resolve to one Program cache entry. The equivalence matrix in
``tests/test_torch_embedded_frontend.py`` pins bit-identical results across
backends and pass configurations.

Use the ``build_*()`` factories for a fresh :class:`GraphProgram` (e.g.
to extend one), or the module-level singletons for direct compilation::

    import repro_torch
    from repro_torch.algorithms.embedded import BFS_ECP_EMBEDDED

    levels = repro_torch.compile(BFS_ECP_EMBEDDED).bind(graph).run(root=0)
"""
from __future__ import annotations

from ..frontend import GraphProgram, to_float


def build_bfs_ecp() -> GraphProgram:
    """Top-down edge-centric BFS (paper Fig. 1), embedded form."""
    p = GraphProgram("bfs_ecp")
    edges = p.edgeset("edges")
    vertices = p.vertexset("vertices")
    old_level = p.vertex_prop("old_level", int)
    new_level = p.vertex_prop("new_level", int)
    tuple_ = p.vertex_prop("tuple", int)
    level = p.scalar("level", int, init=1)
    activeVertex = p.vertex_prop("activeVertex", int)
    root = p.scalar("root", int, init=0)

    @p.vertex_kernel
    def reset(v):
        old_level[v] = -1
        new_level[v] = -1
        tuple_[v] = 2147483647

    @p.edge_kernel
    def EdgeTraversal(src, dst):
        if old_level[src] == level:
            tuple_[dst] = min(tuple_[dst], level + 1)

    @p.vertex_kernel
    def VertexUpdate(v):
        if (tuple_[v] == level + 1) and (old_level[v] == -1):
            new_level[v] = tuple_[v]
            activeVertex[0] = activeVertex[0] + 1

    @p.vertex_kernel
    def VertexApply(v):
        old_level[v] = new_level[v]

    @p.main
    def main():
        vertices.init(reset)
        old_level[root] = 1
        new_level[root] = 1
        frontier_size: int = 1
        while frontier_size:
            edges.process(EdgeTraversal)
            vertices.process(VertexUpdate)
            vertices.process(VertexApply)
            frontier_size = activeVertex[0]
            activeVertex[0] = 0
            level += 1

    return p


def build_pagerank() -> GraphProgram:
    """Edge-centric PageRank with fixed iterations, embedded form."""
    p = GraphProgram("pagerank")
    edges = p.edgeset("edges")
    vertices = p.vertexset("vertices")
    rank = p.vertex_prop("rank", float)
    contrib = p.vertex_prop("contrib", float)
    deg = p.vertex_prop("deg", int, init=edges.out_degrees())
    damp = p.scalar("damp", float, init=0.85)
    iters = p.scalar("iters", int, init=20)

    @p.vertex_kernel
    def initRank(v):
        rank[v] = 1.0 / to_float(vertices.size())
        contrib[v] = 0.0

    @p.edge_kernel
    def computeContrib(src, dst):
        if deg[src] > 0:
            contrib[dst] += rank[src] / to_float(deg[src])

    @p.vertex_kernel
    def applyRank(v):
        rank[v] = (1.0 - damp) / to_float(vertices.size()) + damp * contrib[v]
        contrib[v] = 0.0

    @p.main
    def main():
        vertices.init(initRank)
        i: int = 0
        while i < iters:
            edges.process(computeContrib)
            vertices.process(applyRank)
            i = i + 1

    return p


# ready-to-compile singletons (GraphPrograms are immutable after build:
# to_fir() deep-copies, so sharing them across compiles is safe)
BFS_ECP_EMBEDDED = build_bfs_ecp()
PAGERANK_EMBEDDED = build_pagerank()

__all__ = [
    "build_bfs_ecp",
    "build_pagerank",
    "BFS_ECP_EMBEDDED",
    "PAGERANK_EMBEDDED",
]
